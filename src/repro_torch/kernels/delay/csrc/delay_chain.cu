// Delay chain kernel for Hopper (sm_90a): the paper's §4.1 load model, a
// calibrated per-individual compute delay standing in for sleep(s).
//
// Replaces the delay loop of repro/fitness/benchmarks.py::delay_proxy, a
// lax.fori_loop (not a Pallas kernel) that runs every lane to the batch's
// largest count with a mask:
//     for i in range(max(iters)): a = a + (i < iters[lane]) * sin(a) * 1e-6
// Here each thread owns one lane and stops at its own count. A masked step
// of the reference adds an exact 0, so the values are the same; the time is
// not: a warp costs its lanes' largest count, not the batch's.
//
// Bound: neither bytes nor arithmetic throughput. Each lane reads 8 bytes
// and writes 4; each step is one sinf, one multiply and one add. What bounds
// it is the latency of the dependent chain a -> sinf(a) -> a: a lane's
// steps cannot overlap, so a launch takes at least (largest count) x
// (cycles of one step) at the SM clock, however many lanes run beside it.
//
// Design: one thread per lane, the count and the accumulator in registers,
// one warp per block so the blocks of a small batch spread over as many SMs
// as there are warps. Each step rounds as the reference does: the product
// sin(a) * 1e-6 first, then the sum (__fmul_rn / __fadd_rn are never
// contracted into an FMA). sinf is CUDA's IEEE sinf, not __sinf, and the
// build passes no fast-math flag. A lane with a count <= 0 returns its input
// untouched.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 32;

__global__ void __launch_bounds__(THREADS)
delay_chain_kernel(const float* __restrict__ acc0,
                   const int* __restrict__ iters, float* __restrict__ out,
                   int64_t n) {
    const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    float a = acc0[i];
    const int steps = iters[i];
    // one step per trip: unrolling buys nothing on a dependent chain
#pragma unroll 1
    for (int k = 0; k < steps; ++k)
        a = __fadd_rn(a, __fmul_rn(sinf(a), 1e-6f));
    out[i] = a;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int: 0 on
// success, else the launch's error.
extern "C" int delay_chain_launch(const float* acc0, const int* iters,
                                  float* out, int64_t n, void* stream) {
    if (n <= 0) return (int)cudaGetLastError();
    const int64_t blocks = (n + THREADS - 1) / THREADS;
    delay_chain_kernel<<<(unsigned)blocks, THREADS, 0,
                         (cudaStream_t)stream>>>(acc0, iters, out, n);
    return (int)cudaGetLastError();
}
