"""Device milliseconds per traced step of the kernels that are neither
convolutions (cuDNN's, FFT-based ones included) nor matrix products, nor
NCCL's, nor copies: the batch norms' passes and sums, ReLU, the residual
adds, pooling and SGD."""

from benchmark.trace import COPY_PARTS, has_part

OTHERS = ("conv", "cudnn", "implicit", "fprop", "dgrad", "wgrad", "xmma", "gemm", "fft",
          "cutlass", "nvjet", "cublas", "sm90_", "nccl") + COPY_PARTS


def read(run):
    if run.trace is None or run.unit != "images":
        return None
    seconds = run.trace.time_s(lambda n: not has_part(n, OTHERS))
    return 1e3 * seconds / run.trace.steps if seconds > 0 else None
