"""Device milliseconds per traced step of the kernels that are neither matrix
products (cuBLAS's, and the grouped expert products' CUTLASS kernels), nor
K1, K3 and the dq pass, nor NCCL's, nor copies: the norms, RoPE, the gates,
SwiGLU, routing (sigmoid, top-k), dispatch (the sort, the gathers), the
combine, the cross-entropy, the weight casts and AdamW."""

from benchmark.trace import COPY_PARTS, has_part

OTHERS = ("gemm", "xmma", "cutlass", "nvjet", "cublas", "flash_fwd_kernel",
          "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel", "nccl") + COPY_PARTS


def read(run):
    if run.trace is None or run.unit != "tokens":
        return None
    seconds = run.trace.time_s(lambda n: not has_part(n, OTHERS))
    return 1e3 * seconds / run.trace.steps if seconds > 0 else None
