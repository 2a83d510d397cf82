// Mamba-2 SSD intra-chunk dual form for Hopper (sm_90a) [arXiv:2405.21060].
//
// Replaces the TPU kernel repro/kernels/ssd/chunk_kernel.py::_kernel
// (launched by ssd_intra_chunk, wrapped by ssd/ops.py::ssd_chunked).
//
// Per (batch x chunk, head), with chunk length Q, head dim P, state N and
// B, C shared across heads (n_groups = 1):
//     da     = dt * a_h                  cum = inclusive prefix sum of da
//     L      = tril(exp(cum_i - cum_j))
//     y_diag = ((C B^T) o L o dt_j) X    (Q, P)
//     state  = X^T (B o dt o exp(cum_Q - cum))     (P, N)
//     in_dec = exp(cum)                  (Q,)
//
// Bound: operations. The function needs the Q(Q+1)/2 pairs i >= j only:
// Q(Q+1)N FLOPs of C B^T per chunk (B and C are shared by its H heads),
// then per (chunk, head) Q(Q+1)P (W X) + 2QPN (the state), against
// 4(QP + Q) bytes of x and dt read and 4(QP + PN + Q) written per (chunk,
// head) and 8QN bytes of B and C per chunk. At the main path's (Q, P, N,
// H) = (256, 64, 128, 48) that is ~412 MFLOP per ~8.2 MB: ~50 FLOP per
// byte, above the ~20 an NVIDIA H100 80GB HBM3 at its 700.00 W limit
// offers in float32 (data-sheet peaks: 67 TFLOP/s, 3.35 TB/s). This
// kernel recomputes C B^T for every head.
//
// Design (simple and right first; wgmma, TMA and sharing C B^T across
// heads are later work):
//  * one thread block per (batch x chunk, head), as the TPU grid has it;
//    the block reads x (B, L, H, P), dt (B, L, H), B and C (B, L, N) in
//    place and writes y in the same (B, L, H, P) layout: no regrouping
//    copies around the launch;
//  * dt, cum and the decay to the chunk's end (Q floats each) stay in
//    shared memory for the whole block. cum is an inclusive scan by one
//    warp (each lane sums a run, a shuffle scan joins the runs): the TPU
//    forms it with a ones-tril product, so the summation order differs;
//  * the Q x Q weight w = (C B^T) o L o dt_j is never whole: the block
//    walks 64-row tiles I of the chunk and, for each, the 64-column tiles
//    J <= I (the tiles above the diagonal are zero and skipped). A C_I, a
//    B_J and an X_J tile and the 64 x 64 w tile sit in shared memory
//    (rows of C and B padded by one float so a half-warp's 16 rows fall in
//    16 banks): 102,144 bytes at (P, N, Q) = (64, 128, 256), so two
//    blocks share an H100 SM (at most 232,448 bytes per block);
//  * exp(cum_i - cum_j) is evaluated only for i >= j: above the diagonal
//    the exponent is positive and may overflow, and inf * 0 would be NaN
//    (chunk_kernel.py:54 discards it with a where);
//  * each of the 256 threads computes a 4 x 4 block of w and owns 4 rows
//    x P/16 columns of y (then P/16 x N/16 of the state) in registers;
//  * padded steps (dt = 0, past the end of the sequence) have da = 0 and
//    contribute nothing to y or the state.
// Float32 only. Flags: default nvcc contraction (-fmad=true); the tests'
// tolerance (1e-4) covers multiply-add rounding and the summation order.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int T = 64;             // tile of chunk positions

template <int P, int N>
size_t smem_bytes(int q) {
    return sizeof(float) * (2 * (size_t)T * (N + 1) + (size_t)T * P
                            + (size_t)T * (T + 1) + 3 * (size_t)q);
}

template <int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const float* __restrict__ x,     // (B, L, H, P)
                 const float* __restrict__ dt,    // (B, L, H)
                 const float* __restrict__ a,     // (H,)
                 const float* __restrict__ bm,    // (B, L, N)
                 const float* __restrict__ cm,    // (B, L, N)
                 float* __restrict__ y,           // (B, L, H, P)
                 float* __restrict__ states,      // (B, NC, H, P, N)
                 float* __restrict__ in_decay,    // (B, NC, H, Q)
                 int nc, int q, int h) {
    extern __shared__ float smem[];
    constexpr int NS = N + 1;
    constexpr int WS = T + 1;
    constexpr int PC = P / 16;        // y columns per thread
    constexpr int NCOL = N / 16;      // state columns per thread
    float* Cs = smem;                 // T x NS
    float* Bs = Cs + T * NS;          // T x NS
    float* Xs = Bs + T * NS;          // T x P
    float* Ws = Xs + T * P;           // T x WS
    float* dts = Ws + T * WS;         // Q
    float* cum = dts + q;             // Q
    float* dec = cum + q;             // Q: exp(cum_{Q-1} - cum_j) * dt_j

    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    const int warp = tid >> 5, lane = tid & 31;
    const int bc = blockIdx.x, hh = blockIdx.y;
    const int bi = bc / nc, ci = bc % nc;
    const int64_t tok0 = (int64_t)bi * nc * q + (int64_t)ci * q;
    const float a_h = a[hh];

    for (int j = tid; j < q; j += THREADS) dts[j] = dt[(tok0 + j) * h + hh];
    __syncthreads();
    if (warp == 0) {                  // inclusive scan of da = dt * a_h
        const int per = (q + 31) / 32;
        const int j0 = lane * per;
        const int j1 = min(j0 + per, q);
        float run = 0.0f;
        for (int j = j0; j < j1; ++j) run += dts[j] * a_h;
        float incl = run;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const float o = __shfl_up_sync(0xffffffffu, incl, off);
            if (lane >= off) incl += o;
        }
        run = incl - run;             // sum of the lanes before this one
        for (int j = j0; j < j1; ++j) {
            run += dts[j] * a_h;
            cum[j] = run;
        }
    }
    __syncthreads();
    const float cum_last = cum[q - 1];
    float* dec_out = in_decay + ((int64_t)bc * h + hh) * q;
    for (int j = tid; j < q; j += THREADS) {
        dec[j] = expf(cum_last - cum[j]) * dts[j];
        dec_out[j] = expf(cum[j]);
    }

    const int ntiles = (q + T - 1) / T;
    // ---- y_diag, 64 rows at a time -------------------------------------
    for (int it = 0; it < ntiles; ++it) {
        const int i0 = it * T;
        __syncthreads();
        for (int idx = tid; idx < T * N; idx += THREADS) {
            const int r = idx / N, n = idx % N;
            Cs[r * NS + n] = i0 + r < q ? cm[(tok0 + i0 + r) * N + n] : 0.0f;
        }
        float acc[4][PC];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < PC; ++c) acc[i][c] = 0.0f;

        for (int jt = 0; jt <= it; ++jt) {
            const int j0 = jt * T;
            __syncthreads();
            for (int idx = tid; idx < T * N; idx += THREADS) {
                const int r = idx / N, n = idx % N;
                Bs[r * NS + n] = j0 + r < q ? bm[(tok0 + j0 + r) * N + n]
                                            : 0.0f;
            }
            for (int idx = tid; idx < T * P; idx += THREADS) {
                const int r = idx / P, p = idx % P;
                Xs[r * P + p] = j0 + r < q
                    ? x[((tok0 + j0 + r) * h + hh) * P + p] : 0.0f;
            }
            __syncthreads();

            // w = (C_I B_J^T) o L o dt_j: rows ty + 16 i, columns tx + 16 j
            float cb[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) cb[i][j] = 0.0f;
#pragma unroll 4
            for (int n = 0; n < N; ++n) {
                float cv[4], bv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * NS + n];
#pragma unroll
                for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * NS + n];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) cb[i][j] += cv[i] * bv[j];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int ig = i0 + ty + 16 * i;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int jg = j0 + tx + 16 * j;
                    float w = 0.0f;
                    if (ig >= jg && ig < q)   // exp only on and below the diagonal
                        w = cb[i][j] * expf(cum[ig] - cum[jg]) * dts[jg];
                    Ws[(ty + 16 * i) * WS + tx + 16 * j] = w;
                }
            }
            __syncthreads();

            // y_I += w X_J: rows ty + 16 i, columns tx + 16 c
#pragma unroll 2
            for (int jj = 0; jj < T; ++jj) {
                float wv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) wv[i] = Ws[(ty + 16 * i) * WS + jj];
#pragma unroll
                for (int c = 0; c < PC; ++c) {
                    const float xv = Xs[jj * P + tx + 16 * c];
#pragma unroll
                    for (int i = 0; i < 4; ++i) acc[i][c] += wv[i] * xv;
                }
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int ig = i0 + ty + 16 * i;
            if (ig >= q) continue;
            float* yr = y + ((tok0 + ig) * h + hh) * P;
#pragma unroll
            for (int c = 0; c < PC; ++c) yr[tx + 16 * c] = acc[i][c];
        }
    }

    // ---- chunk state: X^T (B o dec) -------------------------------------
    float st[PC][NCOL];
#pragma unroll
    for (int r = 0; r < PC; ++r)
#pragma unroll
        for (int c = 0; c < NCOL; ++c) st[r][c] = 0.0f;
    for (int jt = 0; jt < ntiles; ++jt) {
        const int j0 = jt * T;
        __syncthreads();
        for (int idx = tid; idx < T * N; idx += THREADS) {
            const int r = idx / N, n = idx % N;
            Bs[r * NS + n] = j0 + r < q
                ? bm[(tok0 + j0 + r) * N + n] * dec[j0 + r] : 0.0f;
        }
        for (int idx = tid; idx < T * P; idx += THREADS) {
            const int r = idx / P, p = idx % P;
            Xs[r * P + p] = j0 + r < q
                ? x[((tok0 + j0 + r) * h + hh) * P + p] : 0.0f;
        }
        __syncthreads();
#pragma unroll 2
        for (int jj = 0; jj < T; ++jj) {
            float xv[PC], bv[NCOL];
#pragma unroll
            for (int r = 0; r < PC; ++r) xv[r] = Xs[jj * P + ty + 16 * r];
#pragma unroll
            for (int c = 0; c < NCOL; ++c) bv[c] = Bs[jj * NS + tx + 16 * c];
#pragma unroll
            for (int r = 0; r < PC; ++r)
#pragma unroll
                for (int c = 0; c < NCOL; ++c) st[r][c] += xv[r] * bv[c];
        }
    }
    float* so = states + ((int64_t)bc * h + hh) * P * N;
#pragma unroll
    for (int r = 0; r < PC; ++r)
#pragma unroll
        for (int c = 0; c < NCOL; ++c)
            so[(ty + 16 * r) * N + tx + 16 * c] = st[r][c];
}

template <int P, int N>
int launch(const float* x, const float* dt, const float* a, const float* bm,
           const float* cm, float* y, float* states, float* in_decay,
           int bsz, int nc, int q, int h, cudaStream_t stream) {
    const size_t bytes = smem_bytes<P, N>(q);
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)(bsz * nc), (unsigned)h);
    ssd_chunk_kernel<P, N><<<grid, THREADS, bytes, stream>>>(
        x, dt, a, bm, cm, y, states, in_decay, nc, q, h);
    return (int)cudaGetLastError();
}

template <int P>
int launch_n(int n, const float* x, const float* dt, const float* a,
             const float* bm, const float* cm, float* y, float* states,
             float* in_decay, int bsz, int nc, int q, int h,
             cudaStream_t stream) {
    switch (n) {
        case 16: return launch<P, 16>(x, dt, a, bm, cm, y, states, in_decay,
                                      bsz, nc, q, h, stream);
        case 64: return launch<P, 64>(x, dt, a, bm, cm, y, states, in_decay,
                                      bsz, nc, q, h, stream);
        case 128: return launch<P, 128>(x, dt, a, bm, cm, y, states,
                                        in_decay, bsz, nc, q, h, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// Plain C entry point (loaded with ctypes). x (B, L, H, P), dt (B, L, H),
// a (H,), b/c (B, L, N) with L = nc * q, all float32 and contiguous;
// outputs y (B, L, H, P), states (B, nc, H, P, N), in_decay (B, nc, H, q).
// P in {32, 64, 128}, N in {16, 64, 128}. Launches on `stream`; returns 0
// or the CUDA error.
extern "C" int ssd_chunk_launch(const float* x, const float* dt,
                                const float* a, const float* bm,
                                const float* cm, float* y, float* states,
                                float* in_decay, int bsz, int nc, int q,
                                int h, int p, int n, void* stream) {
    if (bsz <= 0 || nc <= 0 || h <= 0) return (int)cudaGetLastError();
    if (q <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    switch (p) {
        case 32: return launch_n<32>(n, x, dt, a, bm, cm, y, states,
                                     in_decay, bsz, nc, q, h, st);
        case 64: return launch_n<64>(n, x, dt, a, bm, cm, y, states,
                                     in_decay, bsz, nc, q, h, st);
        case 128: return launch_n<128>(n, x, dt, a, bm, cm, y, states,
                                       in_decay, bsz, nc, q, h, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
