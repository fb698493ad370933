"""Device milliseconds per traced step of the kernels that are neither matrix
products, nor K1-K3, nor NCCL's, nor copies: RMSNorm, RoPE, SwiGLU, the
cross-entropy, the weight casts and AdamW."""

from benchmark.trace import COPY_PARTS, has_part

OTHERS = ("gemm", "xmma", "cutlass", "nvjet", "cublas", "flash_fwd_kernel",
          "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel", "nccl") + COPY_PARTS


def read(run):
    if run.trace is None or run.unit != "tokens":
        return None
    seconds = run.trace.time_s(lambda n: not has_part(n, OTHERS))
    return 1e3 * seconds / run.trace.steps if seconds > 0 else None
