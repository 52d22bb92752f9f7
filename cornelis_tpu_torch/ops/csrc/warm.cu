// Warm-up kernel for Hopper (sm_90a): zero-fill one (8, 128) float32 block.
//
// Replaces cornelis_tpu/ops/pallas_integrator.py::warm_pallas (K2), which
// launched a one-block zero fill through pl.pallas_call so that a process
// paid the device's first-launch initialisation before timed work. On CUDA
// that cost is the context and the lazy module loads, and ops/warm.py pays
// it: it loads every library, forces each megakernel instantiation to load
// (cornelis_megakernel*_load) and launches this kernel once.
//
// What bounds it: nothing of its own. It writes 4 KiB; the launch and, the
// first time, the module load are all of its time. The design: one block of
// BLOCK threads, each storing 1024 / BLOCK floats, on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 128;

__global__ void __launch_bounds__(BLOCK) zero_fill(float* __restrict__ out, int n) {
  for (int i = threadIdx.x; i < n; i += BLOCK) out[i] = 0.0f;
}

}  // namespace

// Zero-fills out[0..n) with one block on `stream`; returns cudaGetLastError().
extern "C" int cornelis_zero_fill(float* out, int n, void* stream) {
  zero_fill<<<1, BLOCK, 0, (cudaStream_t)stream>>>(out, n);
  return (int)cudaGetLastError();
}
