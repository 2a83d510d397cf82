// Fused variation kernel for Hopper (sm_90a): SBX crossover -> polynomial
// mutation -> bound clip in one pass over pre-drawn uniforms.
//
// Replaces the TPU kernel repro/kernels/genetic/fused_variation.py::_kernel
// (launched by fused_variation_pallas, wrapped by genetic/ops.py).
//
// Bound: pure memory traffic. Per launch it reads the parents (4 bytes per
// element of the N x G parent matrix), u_cx and m_gene (2 bytes each: one
// float per gene pair), u_mut and m_genem (4 bytes each) and writes the
// offspring (4 bytes): about 20 * N * G bytes. At N = 32,768 individuals of
// G = 128 genes that is ~84 MB, ~25 us at an H100 SXM's 3.35 TB/s. The
// arithmetic is far below the float32 rate, because the powf work only runs
// where crossover or mutation applies.
//
// Design (simple and right first):
//  * one thread per (pair row r, gene j) computes both children, so the SBX
//    math is shared and every input element is loaded exactly once;
//    neighbouring threads take neighbouring genes, so every warp's loads and
//    stores are coalesced;
//  * parents are read in place as rows 2r and 2r+1 of the flattened
//    (I*P, G) matrix (P even, so a pair never straddles two islands), and
//    the interleaved (I*P, G) offspring are written directly: no x[0::2]
//    copy, no stack/reshape afterwards;
//  * the row masks m_pair (pairs, 1) and m_ind (rows, 1) are read once per
//    row, the bounds once per gene; none of the TPU's 128-lane padding or
//    full-tile broadcasts;
//  * the five hyperparameters [eta_cx, prob_cx, eta_mut, prob_mut, indpb]
//    arrive as a (5,) float32 device array: they stay runtime values (the
//    meta-GA varies them) and never force a host sync;
//  * the uniforms are pre-drawn by the caller, so the kernel is
//    deterministic and comparable with the plain version; an in-kernel
//    Philox mode is later work.
// Precision: IEEE powf and division, no fast math, and the build passes
// -fmad=false, so each operation rounds as the plain float32 version's does
// and only powf's last bits may differ.
#include <cuda_runtime.h>
#include <stdint.h>

#define VAR_EPS 1e-14f

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
    return fminf(fmaxf(x, lo), hi);
}

// The reference evaluates powf on both candidate bases and selects; taking
// the select first and one powf of the chosen base gives the same value
// with one powf instead of two, and no divergent branch.
__device__ __forceinline__ float betaq(float beta, float u, float eta_cx) {
    const float alpha = 2.0f - powf(beta, -(eta_cx + 1.0f));
    const float e = 1.0f / (eta_cx + 1.0f);
    const float base = (u <= 1.0f / alpha)
        ? u * alpha
        : 1.0f / fmaxf(2.0f - u * alpha, VAR_EPS);
    return powf(base, e);
}

__device__ __forceinline__ float mutate(float off, float u2, bool apply,
                                        float lo, float hi, float eta_mut) {
    if (!apply) return off;
    const float span2 = hi - lo;
    const float mp = 1.0f / (eta_mut + 1.0f);
    float deltaq;
    if (u2 < 0.5f) {
        const float d1 = (off - lo) / span2;
        deltaq = powf(fmaxf(2.0f * u2 + (1.0f - 2.0f * u2)
                            * powf(1.0f - d1, eta_mut + 1.0f), VAR_EPS),
                      mp) - 1.0f;
    } else {
        const float d2 = (hi - off) / span2;
        deltaq = 1.0f - powf(fmaxf(2.0f * (1.0f - u2) + 2.0f * (u2 - 0.5f)
                                   * powf(1.0f - d2, eta_mut + 1.0f),
                                   VAR_EPS),
                             mp);
    }
    return clipf(off + deltaq * span2, lo, hi);
}

__global__ void __launch_bounds__(256)
fused_variation_kernel(const float* __restrict__ parents,   // (2*pairs, G)
                       const float* __restrict__ u_cx,      // (pairs, G)
                       const float* __restrict__ m_pair,    // (pairs, 1)
                       const float* __restrict__ m_gene,    // (pairs, G)
                       const float* __restrict__ u_mut,     // (2*pairs, G)
                       const float* __restrict__ m_ind,     // (2*pairs, 1)
                       const float* __restrict__ m_genem,   // (2*pairs, G)
                       const float* __restrict__ lower,     // (G,)
                       const float* __restrict__ upper,     // (G,)
                       const float* __restrict__ scalars,   // (5,)
                       float* __restrict__ out,             // (2*pairs, G)
                       int64_t pairs, int genes) {
    const float eta_cx = scalars[0];
    const float prob_cx = scalars[1];
    const float eta_mut = scalars[2];
    const float prob_mut = scalars[3];
    const float indpb = scalars[4];
    const int64_t total = pairs * genes;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += stride) {
        const int64_t r = i / genes;
        const int j = (int)(i - r * genes);
        const int64_t e1 = 2 * r * genes + j;      // child / parent 1
        const int64_t e2 = e1 + genes;             // child / parent 2
        // every input element is loaded once, whatever the masks decide
        const float a = parents[e1], b = parents[e2];
        const float u = u_cx[i], mg = m_gene[i], mpair = m_pair[r];
        const float um1 = u_mut[e1], um2 = u_mut[e2];
        const float mgm1 = m_genem[e1], mgm2 = m_genem[e2];
        const float mi1 = m_ind[2 * r], mi2 = m_ind[2 * r + 1];
        const float lo = lower[j], hi = upper[j];

        float o1 = a, o2 = b;
        if (mpair < prob_cx && mg < 0.5f) {
            const float y1 = fminf(a, b), y2 = fmaxf(a, b);
            const float span = fmaxf(y2 - y1, VAR_EPS);
            const float b1 = 1.0f + 2.0f * (y1 - lo) / span;
            const float b2 = 1.0f + 2.0f * (hi - y2) / span;
            o1 = clipf(0.5f * ((y1 + y2) - betaq(b1, u, eta_cx) * (y2 - y1)),
                       lo, hi);
            o2 = clipf(0.5f * ((y1 + y2) + betaq(b2, u, eta_cx) * (y2 - y1)),
                       lo, hi);
        }
        out[e1] = mutate(o1, um1, mi1 < prob_mut && mgm1 < indpb,
                         lo, hi, eta_mut);
        out[e2] = mutate(o2, um2, mi2 < prob_mut && mgm2 < indpb,
                         lo, hi, eta_mut);
    }
}

// Plain C entry point (loaded with ctypes). Launches on `stream` and returns
// cudaGetLastError() as an int: 0 on success, else the launch's error.
extern "C" int fused_variation_launch(
        const float* parents, const float* u_cx, const float* m_pair,
        const float* m_gene, const float* u_mut, const float* m_ind,
        const float* m_genem, const float* lower, const float* upper,
        const float* scalars, float* out, int64_t pairs, int genes,
        void* stream) {
    const int64_t total = pairs * (int64_t)genes;
    if (total <= 0) return (int)cudaGetLastError();
    const int threads = 256;
    int64_t blocks = (total + threads - 1) / threads;
    if (blocks > (1 << 20)) blocks = 1 << 20;     // grid-stride beyond this
    fused_variation_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
        parents, u_cx, m_pair, m_gene, u_mut, m_ind, m_genem, lower, upper,
        scalars, out, pairs, genes);
    return (int)cudaGetLastError();
}
