// The device side of the port's spans (runtime/stepstats.py): four empty
// kernels, tpujob_span_mark_{fwd,bwd,opt,end}, that Trainer.train_step
// launches on its current stream at four points of a step (before the
// forward, before the backward, after the backward, after the update) while
// a torch.profiler capture runs, and two, tpujob_span_mark_{mla_in,mla_attn},
// that models/deepseek_v3.py launches in each layer's latent attention
// (before its projections, and before K1).
//
// They replace no TPU kernel. They exist so that a device trace shows when
// the stream reached each of those points: a mark's start in the trace is
// the point, on the kernels' own clock, which host-side spans cannot give
// to a reader of the device timeline. Each point has a kernel of its own
// because a trace names kernels and nothing else: a capture can lose its
// first device operation, and a mark that says which point it is keeps the
// rest of the step readable. One thread, no memory read or written, no
// work: what bounds a mark is its launch alone (a few microseconds of host
// time), and marks are launched only during a capture.
//
// The names are the port's alone (extern "C", so unmangled): readers find
// the marks by them.

#include <cuda_runtime.h>

extern "C" __global__ void tpujob_span_mark_fwd() {}
extern "C" __global__ void tpujob_span_mark_bwd() {}
extern "C" __global__ void tpujob_span_mark_opt() {}
extern "C" __global__ void tpujob_span_mark_end() {}
extern "C" __global__ void tpujob_span_mark_mla_in() {}
extern "C" __global__ void tpujob_span_mark_mla_attn() {}

extern "C" {

// point: 0 fwd, 1 bwd, 2 opt, 3 end, 4 mla_in, 5 mla_attn
int tpujob_span_mark_launch(int point, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (point) {
    case 0: tpujob_span_mark_fwd<<<1, 1, 0, s>>>(); break;
    case 1: tpujob_span_mark_bwd<<<1, 1, 0, s>>>(); break;
    case 2: tpujob_span_mark_opt<<<1, 1, 0, s>>>(); break;
    case 3: tpujob_span_mark_end<<<1, 1, 0, s>>>(); break;
    case 4: tpujob_span_mark_mla_in<<<1, 1, 0, s>>>(); break;
    case 5: tpujob_span_mark_mla_attn<<<1, 1, 0, s>>>(); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* tpujob_span_mark_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
