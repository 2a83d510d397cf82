// Fused variation kernel for Hopper (sm_90a): SBX crossover -> polynomial
// mutation -> bound clip in one pass over pre-drawn uniforms.
//
// Replaces the TPU kernel repro/kernels/genetic/fused_variation.py::_kernel
// (launched by fused_variation_pallas, wrapped by genetic/ops.py).
//
// Bound: memory traffic. Per launch it reads the parents (4 bytes per
// element of the N x G parent matrix), u_cx and m_gene (2 bytes each: one
// float per gene pair), u_mut and m_genem (4 bytes each) and writes the
// offspring (4 bytes): about 20 * N * G bytes. At N = 32,768 individuals of
// G = 128 genes that is ~84 MB, ~25 us at an H100 SXM's 3.35 TB/s.
//
// What stands in the way is instruction issue, not arithmetic throughput:
// crossover applies per gene (m_pair < prob_cx && m_gene < 0.5), so at
// prob_cx = 0.9 nearly every warp holds some crossing gene while only
// ~45% of its genes cross, and each crossing gene runs four IEEE powf and
// two IEEE divisions (hundreds of instructions). A thread-per-gene kernel
// pays that branch for all 32 lanes of nearly every warp. Mutation is
// rarer still (prob_mut x indpb, 0.55% of child genes at G = 128) and
// costs a warp the same whenever one of its lanes mutates.
//
// Design:
//  * a warp takes 128 consecutive pair-genes of the flattened (pairs, G)
//    matrix per step, four per lane. Float4 layout: when G % 4 == 0 and
//    every streamed pointer is 16-byte aligned, a lane owns one float4 of
//    a pair row r: genes j..j+3 of parent rows 2r and 2r+1, read in place
//    from the (I*P, G) matrix (P even, so a pair never straddles two
//    islands), the interleaved offspring written in place too. Strided
//    layout otherwise: slot k of lane l is the warp's pair-gene 32 k + l,
//    read with scalar loads coalesced over the warp. The launcher picks
//    the template; both are this kernel;
//  * index math in 32 bits when pairs * G < 2^31 (every shape the port
//    runs), a 64-bit template beyond;
//  * loads ahead of math: a thread issues all its loads (eight streams,
//    and the row masks m_pair and m_ind) before any arithmetic. The
//    once-used uniform streams are read with streaming loads
//    (ld.global.cs); the offspring are stored with ordinary stores, since
//    fitness reads them next from L2. The bounds (2G floats, L1-resident)
//    are read by gene index in the compacted rounds below, where a lane
//    works on other lanes' genes;
//  * warp compaction: each warp ballots its crossover mask over its 128
//    pair-genes, lays the active ones densely into a per-warp
//    shared-memory buffer (a, b, u, gene), runs the SBX math over that
//    buffer in ceil(n_active / 32) rounds with every lane busy, and reads
//    (o1, o2) back from the same slots. At ~45% crossing that is 2 rounds
//    where four per-lane branches would each diverge. Mutation is
//    compacted the same way over its own per-child-gene mask (off, u2,
//    gene), so most warps skip it. Shared memory and not __shfl_sync: a
//    lane holds four slots, a shuffle reads one register of its source
//    lane, and finding the source of a dense slot (the n-th set bit of
//    four ballots) costs more than one store and one load per operand;
//  * the five hyperparameters [eta_cx, prob_cx, eta_mut, prob_mut, indpb]
//    arrive as a float32 device array: they stay runtime values (the
//    meta-GA varies them) and never force a host sync. One (5,) row for
//    the whole launch, read once per thread; or one row per run (the
//    meta-GA's inner GAs, R = individuals x seeds runs of P/2 pair rows
//    each), where pair row r reads row r / run_pairs: the masks' three
//    probabilities per slot at load time, and the exponents per element
//    inside the compacted rounds, from the run index stored beside the
//    gene index. The table is R x 20 bytes (9.6 KB at the meta-GA's 480
//    runs) and stays in L1;
//  * the uniforms may be shared across runs: pair row r reads uniform row
//    r % rnd_pairs, so the meta-GA's (seeds, P, G) draws serve every
//    individual (common random numbers) without being expanded to
//    (individuals, seeds, P, G). The launcher takes the BATCHED template
//    for either form, and the one-row, unshared launch keeps the code it
//    had;
//  * the uniforms are pre-drawn by the caller, so the kernel is
//    deterministic and comparable with the plain version.
// Precision: IEEE powf and division, no fast math, and the build passes
// -fmad=false, so each operation rounds as the plain float32 version's
// does. Compaction changes which lane computes an element, never the
// operations on it, so the results are bit-for-bit those of a
// thread-per-gene kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#define VAR_EPS 1e-14f

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int WARP = 32;
// two warps per block: blocks of 128 and 256 threads ran the main shape a
// few percent slower on an H100
constexpr int THREADS = 64;
constexpr int WARPS = THREADS / WARP;
// pair-genes per lane, and per warp per step
constexpr int SLOTS = 4;
constexpr int SPAN = WARP * SLOTS;
constexpr int64_t MAX_BLOCKS = 1 << 20;       // grid-stride beyond this

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
    return fminf(fmaxf(x, lo), hi);
}

// Exponents of one hyperparameter row, formed with the plain version's
// float32 operations: once per thread for a one-row launch, per element
// inside the compacted rounds for a launch with one row per run.
struct Exponents {
    float cx_alpha;   // -(eta_cx + 1)
    float cx_root;    // 1 / (eta_cx + 1)
    float mut_pow;    // eta_mut + 1
    float mut_root;   // 1 / (eta_mut + 1)
};

// The exponents of the row at `row` ([eta_cx, prob_cx, eta_mut, ...]).
__device__ __forceinline__ Exponents exponents(const float* row) {
    const float eta_cx = __ldg(row), eta_mut = __ldg(row + 2);
    return {-(eta_cx + 1.0f), 1.0f / (eta_cx + 1.0f), eta_mut + 1.0f,
            1.0f / (eta_mut + 1.0f)};
}

// The reference evaluates powf on both candidate bases and selects; taking
// the select first and one powf of the chosen base gives the same value
// with one powf instead of two, and no divergent branch.
__device__ __forceinline__ float betaq(float beta, float u,
                                       const Exponents& x) {
    const float alpha = 2.0f - powf(beta, x.cx_alpha);
    const float base = (u <= 1.0f / alpha)
        ? u * alpha
        : 1.0f / fmaxf(2.0f - u * alpha, VAR_EPS);
    return powf(base, x.cx_root);
}

// SBX children of one parent-gene pair (a, b), crossover applied.
__device__ __forceinline__ void sbx(float a, float b, float u, float lo,
                                    float hi, const Exponents& x, float& o1,
                                    float& o2) {
    const float y1 = fminf(a, b), y2 = fmaxf(a, b);
    const float span = fmaxf(y2 - y1, VAR_EPS);
    const float b1 = 1.0f + 2.0f * (y1 - lo) / span;
    const float b2 = 1.0f + 2.0f * (hi - y2) / span;
    o1 = clipf(0.5f * ((y1 + y2) - betaq(b1, u, x) * (y2 - y1)), lo, hi);
    o2 = clipf(0.5f * ((y1 + y2) + betaq(b2, u, x) * (y2 - y1)), lo, hi);
}

// Polynomial mutation of one child gene, mutation applied. The reference
// computes the lower-side (u2 < 0.5) and upper-side deltas and selects;
// selecting the side's operands first runs the same operations on them
// once, with no divergent branch:
//   lower: powf(max(2 u2 + (1 - 2 u2) (1 - d1)^e, eps), mp) - 1
//   upper: 1 - powf(max(2 (1 - u2) + 2 (u2 - 0.5) (1 - d2)^e, eps), mp)
// with e = eta_mut + 1, d1 = (off - lo) / span2, d2 = (hi - off) / span2.
__device__ __forceinline__ float mutate(float off, float u2, float lo,
                                        float hi, const Exponents& x) {
    const float span2 = hi - lo;
    const bool low = u2 < 0.5f;
    const float d = (low ? off - lo : hi - off) / span2;
    const float t = powf(1.0f - d, x.mut_pow);
    const float base = low ? 2.0f * u2 + (1.0f - 2.0f * u2) * t
                           : 2.0f * (1.0f - u2) + 2.0f * (u2 - 0.5f) * t;
    const float p = powf(fmaxf(base, VAR_EPS), x.mut_root);
    const float deltaq = low ? p - 1.0f : 1.0f - p;
    return clipf(off + deltaq * span2, lo, hi);
}

// Four consecutive floats at p, one 16-byte load. STREAM: ld.global.cs
// (read once, evict first); else ld.global.nc.
template <bool STREAM>
__device__ __forceinline__ void load4(float (&x)[SLOTS], const float* p) {
    const float4* q = reinterpret_cast<const float4*>(p);
    const float4 v = STREAM ? __ldcs(q) : __ldg(q);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

template <bool STREAM>
__device__ __forceinline__ float load1(const float* p) {
    return STREAM ? __ldcs(p) : __ldg(p);
}

// Warp compaction: slot s of this lane is active where on[s]; pos[s] is
// its place in the warp's dense list, ordered by (slot, lane). Returns the
// number of active slots of the warp (the same in every lane).
template <int S>
__device__ __forceinline__ int compact(const bool (&on)[S], int (&pos)[S],
                                       unsigned lanes_below) {
    int n = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const unsigned m = __ballot_sync(FULL_MASK, on[s]);
        pos[s] = n + __popc(m & lanes_below);
        n += __popc(m);
    }
    return n;
}

// A warp takes SPAN consecutive pair-genes of the flattened (pairs, G)
// matrix per step; slot k of lane l is its pair-gene
//   VEC4:  SLOTS l + k  (one float4 of a pair row: G % 4 == 0),
//   else:  WARP k + l   (scalar loads, each slot coalesced over the warp).
// The loop runs per warp, so every lane reaches every ballot and
// __syncwarp; slots past the end are masked off. BATCHED: one
// hyperparameter row per run of run_pairs pair rows, and uniforms of
// rnd_pairs pair rows read at pair row r % rnd_pairs (else one row, and
// rnd_pairs == run_pairs == pairs).
template <bool VEC4, bool BATCHED, typename Idx>
__global__ void __launch_bounds__(THREADS)
fused_variation_kernel(const float* __restrict__ parents,   // (2*pairs, G)
                       const float* __restrict__ u_cx,      // (rnd_pairs, G)
                       const float* __restrict__ m_pair,    // (rnd_pairs, 1)
                       const float* __restrict__ m_gene,    // (rnd_pairs, G)
                       const float* __restrict__ u_mut,     // (2*rnd_pairs, G)
                       const float* __restrict__ m_ind,     // (2*rnd_pairs, 1)
                       const float* __restrict__ m_genem,   // (2*rnd_pairs, G)
                       const float* __restrict__ lower,     // (G,)
                       const float* __restrict__ upper,     // (G,)
                       const float* __restrict__ scalars,   // (runs, 5)
                       float* __restrict__ out,             // (2*pairs, G)
                       Idx total, int genes,                // total = pairs*G
                       Idx rnd_pairs, Idx run_pairs) {
    // per warp: SBX slots (a, b, u, gene[, run]) x SPAN, or mutation
    // slots (off, u2, gene[, run]) x 2 SPAN; gene and run indices are
    // stored as float bits
    constexpr int FIELDS = BATCHED ? 4 : 3;
    __shared__ float buffer[WARPS][FIELDS * 2 * SPAN];
    constexpr int CX = SPAN, MUT = 2 * SPAN;
    const unsigned lane = threadIdx.x % WARP;
    const unsigned lanes_below = (1u << lane) - 1u;
    float* const buf = buffer[threadIdx.x / WARP];

    // the one-row launch's hyperparameters (unused where BATCHED)
    const float prob_cx = scalars[1];
    const float prob_mut = scalars[3];
    const float indpb = scalars[4];
    const Exponents x = exponents(scalars);
    const Idx G = (Idx)genes;
    const Idx stride = (Idx)gridDim.x * WARPS * SPAN;

    for (Idx base = ((Idx)blockIdx.x * WARPS + threadIdx.x / WARP) * SPAN;
         base < total; base += stride) {
        // pair-gene el[k] of pair row r[k], gene j[k]; its parents and
        // children lie at e1[k] = 2 r G + j (row 2r) and e1[k] + G; its
        // uniforms at eu[k] (pair streams) and e1u[k] (child streams) of
        // uniform pair row ru[k]; its hyperparameters in row run[k]
        bool ok[SLOTS];
        Idx el[SLOTS], r[SLOTS], e1[SLOTS], ru[SLOTS], eu[SLOTS], e1u[SLOTS];
        int j[SLOTS], run[SLOTS];
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) {
            el[k] = base + (VEC4 ? SLOTS * lane + k : WARP * k + lane);
            if (VEC4 && k > 0) {        // the float4's row: one division
                ok[k] = ok[0];
                r[k] = r[0];
                j[k] = j[0] + k;
                ru[k] = ru[0];
                run[k] = run[0];
            } else {
                ok[k] = el[k] < total;
                r[k] = ok[k] ? el[k] / G : 0;
                j[k] = ok[k] ? (int)(el[k] - r[k] * G) : 0;
                ru[k] = BATCHED ? r[k] % rnd_pairs : r[k];
                run[k] = BATCHED ? (int)(r[k] / run_pairs) : 0;
            }
            e1[k] = el[k] + r[k] * G;
            eu[k] = BATCHED ? ru[k] * G + j[k] : el[k];
            e1u[k] = BATCHED ? eu[k] + ru[k] * G : e1[k];
        }
        // the masks' probabilities of each slot's run
        float pcx[SLOTS], pmut[SLOTS], pgene[SLOTS];
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) {
            if (BATCHED && (!VEC4 || k == 0)) {
                const float* row = scalars + 5 * (Idx)run[k];
                pcx[k] = __ldg(row + 1);
                pmut[k] = __ldg(row + 3);
                pgene[k] = __ldg(row + 4);
            } else if (BATCHED) {
                pcx[k] = pcx[0];
                pmut[k] = pmut[0];
                pgene[k] = pgene[0];
            } else {
                pcx[k] = prob_cx;
                pmut[k] = prob_mut;
                pgene[k] = indpb;
            }
        }

        // every load before any arithmetic
        float a[SLOTS] = {}, b[SLOTS] = {}, u[SLOTS] = {}, mg[SLOTS] = {};
        float um1[SLOTS] = {}, um2[SLOTS] = {}, mm1[SLOTS] = {},
              mm2[SLOTS] = {};
        float mpair[SLOTS] = {}, mi1[SLOTS] = {}, mi2[SLOTS] = {};
        if constexpr (VEC4) {
            if (ok[0]) {
                load4<false>(a, parents + e1[0]);
                load4<false>(b, parents + e1[0] + G);
                load4<!BATCHED>(u, u_cx + eu[0]);
                load4<!BATCHED>(mg, m_gene + eu[0]);
                load4<!BATCHED>(um1, u_mut + e1u[0]);
                load4<!BATCHED>(um2, u_mut + e1u[0] + G);
                load4<!BATCHED>(mm1, m_genem + e1u[0]);
                load4<!BATCHED>(mm2, m_genem + e1u[0] + G);
                const float mp = __ldg(m_pair + ru[0]);
                const float i1 = __ldg(m_ind + 2 * ru[0]);
                const float i2 = __ldg(m_ind + 2 * ru[0] + 1);
#pragma unroll
                for (int k = 0; k < SLOTS; ++k) {
                    mpair[k] = mp;
                    mi1[k] = i1;
                    mi2[k] = i2;
                }
            }
        } else {
#pragma unroll
            for (int k = 0; k < SLOTS; ++k) {
                if (ok[k]) {
                    a[k] = load1<false>(parents + e1[k]);
                    b[k] = load1<false>(parents + e1[k] + G);
                    u[k] = load1<!BATCHED>(u_cx + eu[k]);
                    mg[k] = load1<!BATCHED>(m_gene + eu[k]);
                    um1[k] = load1<!BATCHED>(u_mut + e1u[k]);
                    um2[k] = load1<!BATCHED>(u_mut + e1u[k] + G);
                    mm1[k] = load1<!BATCHED>(m_genem + e1u[k]);
                    mm2[k] = load1<!BATCHED>(m_genem + e1u[k] + G);
                    mpair[k] = __ldg(m_pair + ru[k]);
                    mi1[k] = __ldg(m_ind + 2 * ru[k]);
                    mi2[k] = __ldg(m_ind + 2 * ru[k] + 1);
                }
            }
        }

        // SBX, compacted over the warp's crossing pair-genes
        bool cx[SLOTS];
        int pos[SLOTS];
        float off[2 * SLOTS];                 // children: row 2r, row 2r+1
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) {
            cx[k] = ok[k] && mpair[k] < pcx[k] && mg[k] < 0.5f;
            off[k] = a[k];
            off[SLOTS + k] = b[k];
        }
        int n = compact<SLOTS>(cx, pos, lanes_below);
        if (n) {
            float* const sa = buf;
            float* const sb = buf + CX;
            float* const su = buf + 2 * CX;
            float* const sg = buf + 3 * CX;
            float* const sr = buf + 4 * CX;     // BATCHED only
#pragma unroll
            for (int k = 0; k < SLOTS; ++k) {
                if (cx[k]) {
                    sa[pos[k]] = a[k];
                    sb[pos[k]] = b[k];
                    su[pos[k]] = u[k];
                    sg[pos[k]] = __int_as_float(j[k]);
                    if (BATCHED) sr[pos[k]] = __int_as_float(run[k]);
                }
            }
            __syncwarp();
            for (int t = lane; t < n; t += WARP) {
                const int g = __float_as_int(sg[t]);
                Exponents xr = x;
                if constexpr (BATCHED)
                    xr = exponents(scalars + 5 * (Idx)__float_as_int(sr[t]));
                float c1, c2;
                sbx(sa[t], sb[t], su[t], __ldg(lower + g), __ldg(upper + g),
                    xr, c1, c2);
                sa[t] = c1;
                sb[t] = c2;
            }
            __syncwarp();
#pragma unroll
            for (int k = 0; k < SLOTS; ++k) {
                if (cx[k]) {
                    off[k] = sa[pos[k]];
                    off[SLOTS + k] = sb[pos[k]];
                }
            }
            __syncwarp();
        }

        // polynomial mutation, compacted over the warp's mutating genes
        bool mu[2 * SLOTS];
        int mpos[2 * SLOTS];
        float u2[2 * SLOTS];
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) {
            mu[k] = ok[k] && mi1[k] < pmut[k] && mm1[k] < pgene[k];
            mu[SLOTS + k] = ok[k] && mi2[k] < pmut[k] && mm2[k] < pgene[k];
            u2[k] = um1[k];
            u2[SLOTS + k] = um2[k];
        }
        n = compact<2 * SLOTS>(mu, mpos, lanes_below);
        if (n) {
            float* const so = buf;
            float* const su = buf + MUT;
            float* const sg = buf + 2 * MUT;
            float* const sr = buf + 3 * MUT;    // BATCHED only
#pragma unroll
            for (int s = 0; s < 2 * SLOTS; ++s) {
                if (mu[s]) {
                    so[mpos[s]] = off[s];
                    su[mpos[s]] = u2[s];
                    sg[mpos[s]] = __int_as_float(j[s % SLOTS]);
                    if (BATCHED) sr[mpos[s]] = __int_as_float(run[s % SLOTS]);
                }
            }
            __syncwarp();
            for (int t = lane; t < n; t += WARP) {
                const int g = __float_as_int(sg[t]);
                Exponents xr = x;
                if constexpr (BATCHED)
                    xr = exponents(scalars + 5 * (Idx)__float_as_int(sr[t]));
                so[t] = mutate(so[t], su[t], __ldg(lower + g),
                               __ldg(upper + g), xr);
            }
            __syncwarp();
#pragma unroll
            for (int s = 0; s < 2 * SLOTS; ++s) {
                if (mu[s]) off[s] = so[mpos[s]];
            }
            __syncwarp();
        }

        if constexpr (VEC4) {
            if (ok[0]) {
                *reinterpret_cast<float4*>(out + e1[0]) =
                    make_float4(off[0], off[1], off[2], off[3]);
                *reinterpret_cast<float4*>(out + e1[0] + G) =
                    make_float4(off[4], off[5], off[6], off[7]);
            }
        } else {
#pragma unroll
            for (int k = 0; k < SLOTS; ++k) {
                if (ok[k]) {
                    out[e1[k]] = off[k];
                    out[e1[k] + G] = off[SLOTS + k];
                }
            }
        }
    }
}

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Template code: bit 0 the float4 layout, bit 1 64-bit index math.
int pick(const float* parents, const float* u_cx, const float* m_gene,
         const float* u_mut, const float* m_genem, const float* lower,
         const float* upper, const float* out, int64_t pairs, int genes) {
    const bool vec = genes % 4 == 0 && aligned16(parents) &&
        aligned16(u_cx) && aligned16(m_gene) && aligned16(u_mut) &&
        aligned16(m_genem) && aligned16(lower) && aligned16(upper) &&
        aligned16(out);
    const bool wide = pairs * (int64_t)genes >= ((int64_t)1 << 31);
    return (vec ? 1 : 0) | (wide ? 2 : 0);
}

template <bool VEC4, bool BATCHED, typename Idx>
void launch(const float* parents, const float* u_cx, const float* m_pair,
            const float* m_gene, const float* u_mut, const float* m_ind,
            const float* m_genem, const float* lower, const float* upper,
            const float* scalars, float* out, int64_t pairs, int genes,
            int64_t rnd_pairs, int64_t run_pairs, cudaStream_t stream) {
    const int64_t total = pairs * genes;
    const int64_t per_block = (int64_t)WARPS * SPAN;
    int64_t blocks = (total + per_block - 1) / per_block;
    if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
    fused_variation_kernel<VEC4, BATCHED, Idx><<<(unsigned)blocks, THREADS,
                                                 0, stream>>>(
        parents, u_cx, m_pair, m_gene, u_mut, m_ind, m_genem, lower, upper,
        scalars, out, (Idx)total, genes, (Idx)rnd_pairs, (Idx)run_pairs);
}

template <bool BATCHED>
void launch_picked(int code, const float* parents, const float* u_cx,
                   const float* m_pair, const float* m_gene,
                   const float* u_mut, const float* m_ind,
                   const float* m_genem, const float* lower,
                   const float* upper, const float* scalars, float* out,
                   int64_t pairs, int genes, int64_t rnd_pairs,
                   int64_t run_pairs, cudaStream_t s) {
    switch (code) {
    case 0:
        launch<false, BATCHED, uint32_t>(
            parents, u_cx, m_pair, m_gene, u_mut, m_ind, m_genem, lower,
            upper, scalars, out, pairs, genes, rnd_pairs, run_pairs, s);
        break;
    case 1:
        launch<true, BATCHED, uint32_t>(
            parents, u_cx, m_pair, m_gene, u_mut, m_ind, m_genem, lower,
            upper, scalars, out, pairs, genes, rnd_pairs, run_pairs, s);
        break;
    case 2:
        launch<false, BATCHED, uint64_t>(
            parents, u_cx, m_pair, m_gene, u_mut, m_ind, m_genem, lower,
            upper, scalars, out, pairs, genes, rnd_pairs, run_pairs, s);
        break;
    default:
        launch<true, BATCHED, uint64_t>(
            parents, u_cx, m_pair, m_gene, u_mut, m_ind, m_genem, lower,
            upper, scalars, out, pairs, genes, rnd_pairs, run_pairs, s);
        break;
    }
}

}  // namespace

// Plain C entry points (loaded with ctypes).

// The template a launch with these pointers and sizes takes (see pick).
extern "C" int fused_variation_template(
        const float* parents, const float* u_cx, const float* m_gene,
        const float* u_mut, const float* m_genem, const float* lower,
        const float* upper, const float* out, int64_t pairs, int genes) {
    return pick(parents, u_cx, m_gene, u_mut, m_genem, lower, upper, out,
                pairs, genes);
}

// Launches on `stream`, one warp per SPAN pair-genes, and returns
// cudaGetLastError() as an int: 0 on success, else the launch's error.
// The uniforms hold rnd_pairs pair rows (a divisor of pairs: they repeat
// over the leading runs), and each hyperparameter row serves run_pairs
// pair rows (pairs for a (5,) row); the BATCHED template runs where either
// differs from pairs.
extern "C" int fused_variation_launch(
        const float* parents, const float* u_cx, const float* m_pair,
        const float* m_gene, const float* u_mut, const float* m_ind,
        const float* m_genem, const float* lower, const float* upper,
        const float* scalars, float* out, int64_t pairs, int genes,
        int64_t rnd_pairs, int64_t run_pairs, void* stream) {
    if (pairs <= 0 || genes <= 0) return (int)cudaGetLastError();
    if (rnd_pairs <= 0 || run_pairs <= 0 || pairs % rnd_pairs ||
        pairs % run_pairs)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    const int code = pick(parents, u_cx, m_gene, u_mut, m_genem, lower,
                          upper, out, pairs, genes);
    if (rnd_pairs == pairs && run_pairs == pairs)
        launch_picked<false>(code, parents, u_cx, m_pair, m_gene, u_mut,
                             m_ind, m_genem, lower, upper, scalars, out,
                             pairs, genes, rnd_pairs, run_pairs, s);
    else
        launch_picked<true>(code, parents, u_cx, m_pair, m_gene, u_mut,
                            m_ind, m_genem, lower, upper, scalars, out,
                            pairs, genes, rnd_pairs, run_pairs, s);
    return (int)cudaGetLastError();
}
