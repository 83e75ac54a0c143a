// Unrolled micro-program kernels for Hopper (sm_90a), plain FP32 FMA.
//
// Replaces qcpinn_tpu/ops/pallas_sv.py::_forward_kernel (K3) and
// ::_backward_kernel (K4); qc_unrolled_reduce (K4b, slab_sum.cuh) is the
// fixed-order sum of K4's phase cotangents, which the TPU kernel
// accumulates over its sequential grid. The state of one sample is a row
// of 2^n split re/im f32 amplitudes, wire 0 the most significant bit. A
// step is one of
//   mat  : a per-sample 2x2 from the [B, K, 2, 2] re/im banks on target bit
//          ga, optionally only where control bit gb is 1 (the JAX 1q / c1q;
//          with the encoding the first n are the per-sample RX gates);
//   diag : multiply by a phase row (cos + i sin)[2^n] from the [P, 2^n]
//          banks;
//   u2q  : a fixed 4x4 from the [U, 32] bank on bits (ga, gb) = (ctrl,
//          wire), index order (bit_a, bit_b), as u.reshape(2, 2, 2, 2).
// The partner of amplitude i across bit g is i ^ (1 << g): the TPU
// kernel's two rolls and bit select (pallas_sv.py::_swap) exist only for
// Mosaic's layout and are not carried.
//
// The program is not unrolled into code: it arrives as a step table passed
// by value in the kernel parameters (<= GT_MAX_STEPS steps), so one build
// serves every circuit and Mosaic's per-circuit compile cost has no
// counterpart.
//
// The backward sweeps the program in reverse from the final state with
// O(1) extra state: it applies each gate's inverse (conj-transposed 2x2 or
// 4x4, conjugate phase) to recover the step's input, writes the sample's
// matrix cotangent mbar[i][j] = sum g_i conj(x_j) over the gated pairs
// and pulls the cotangent g back through the same inverse. The phase
// cotangents are batch sums: a persistent grid of G CTAs sums its samples
// into one private slab each, and the slab sum (slab_sum.cuh) adds the G
// slabs in a fixed order. No float atomics: two runs are bit-equal.
//
// Two routes for each direction, picked by n in sv_kernel.py (route()):
//   warp route, 1 <= n <= 9 (unrolled_{fwd,bwd}_warp_kernel_rb*): one warp
//     holds a sample in registers for the whole program, no barrier;
//   tile route, 10 <= n <= 12 (unrolled_{fwd,bwd}_tile_kernel*): one CTA
//     holds a sample in shared memory and walks the program's segments
//     (runs of steps whose target bits fit in US_TILE_BITS bits; the host
//     marks each segment's last step with US_SEG_END), each thread a tile
//     of 2^US_TILE_BITS amplitudes in registers, one barrier a segment.
// Both directions share one set of device functions, templated on BWD
// (the backward's two planes, inverse gates and matrix-cotangent sums, or
// the forward's one plane and plain gates).
//
// What bounds them: every step touches each amplitude once with a handful
// of flops, so the work is instruction issue (FMA, shuffles, shared-memory
// traffic) and, at a small batch, the program's latency; nothing in a
// sweep waits on device memory (the sample's matrices come into shared
// memory with its state, the phase rows and the 4x4s once a CTA).
//
// The table, the addressing and the 4x4 layout are shared with
// gate_loop.cu (gate_table.cuh), the slab sum with every backward. Plain C
// interface (loaded with ctypes); every entry returns cudaGetLastError()
// after its launch.

#include "gate_table.cuh"
#include "slab_sum.cuh"

#define US_MAX_QUBITS 12
// The step word's spare bit 13 marks a segment's last step (gate_table.cuh
// decodes bits 0-12 and 16-31; gate_loop.cu's tables never set it).
#define US_SEG_END (1u << 13)

// -- K3/K4 for 1 <= n <= 9: the warp-resident sweep --------------------------
//
// One warp holds a sample in registers for the whole program: its 2^n
// amplitudes, re and im (and in the backward the cotangent's), are
// R = 2^RB registers a lane each (RB = max(n - 5, 0): 8 at 8 qubits),
// amplitude i in lane i >> RB, register i & (R - 1). The low RB bits index
// the registers, the high bits the lane. A gate on a register bit is local
// to a lane; on a lane bit it takes one __shfl_xor_sync per value (the
// partner lane's amplitude); a u2q gathers its quad from up to four lanes.
// At n < 5 the lanes beyond 2^n hold zeros and sit idle. The sweep has no
// barrier. In the backward:
//   - mat: each lane accumulates its pairs' share of mbar[i][j] =
//     sum g_i conj(x_j) in 8 floats, the warp sums them in a fixed
//     butterfly that scatters the 8 sums over lane groups (9 shuffles), and
//     one lane of each group adds its entry into the sample's [K, 2, 2]
//     cotangents in the warp's shared memory; the warp writes them to
//     device memory once per sample, each lane its share;
//   - diag: each lane owns fixed amplitude indices, so it accumulates the
//     phase cotangents of its indices over every sample its warp sweeps,
//     in registers for the first UW_PHASE_REGS phase rows (the main paths
//     have 2: 2 * 2 * 8 = 32 floats a lane at 8 qubits) and in the warp's
//     shared memory (each lane its own slots) for any further row.
// After the sweep the warps of the CTA add their phase cotangents in warp
// order through shared memory, behind one barrier, into the CTA's slab;
// the slab sum (K4b) adds the slabs. A persistent grid: warp w of CTA c
// sweeps samples c * W + w, + G * W, ...
//
// Per step a lane does R/2 (register bit) or R (lane bit, with 2 shuffles
// each forward, 4 backward) pair updates, so the work is instruction
// throughput over the batch and, at one sample a warp, the sweep's
// latency. Nothing in a step branches per amplitude: a control bit
// selects, it does not skip, so a step is straight-line code.

#define UW_MAX_QUBITS 9
#define UW_MAX_RB (UW_MAX_QUBITS - 5)
#define UW_PHASE_REGS 2
#define UW_MAX_WARPS 8
#define FULL_MASK 0xffffffffu

// v[0..R) <- p[0..R): 16-byte loads where the row allows them.
template <int R>
__device__ __forceinline__ void uw_load(const float* __restrict__ p, float (&v)[R]) {
    if constexpr (R % 4 == 0) {
        if ((reinterpret_cast<size_t>(p) & 15) == 0) {
#pragma unroll
            for (int r = 0; r < R; r += 4) {
                const float4 t = *reinterpret_cast<const float4*>(p + r);
                v[r] = t.x;
                v[r + 1] = t.y;
                v[r + 2] = t.z;
                v[r + 3] = t.w;
            }
            return;
        }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = p[r];
}

template <int R>
__device__ __forceinline__ void uw_store(float* __restrict__ p, const float (&v)[R]) {
    if constexpr (R % 4 == 0) {
        if ((reinterpret_cast<size_t>(p) & 15) == 0) {
#pragma unroll
            for (int r = 0; r < R; r += 4)
                *reinterpret_cast<float4*>(p + r) =
                    make_float4(v[r], v[r + 1], v[r + 2], v[r + 3]);
            return;
        }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) p[r] = v[r];
}

// The warp's sum of v[8] over its 32 lanes in a fixed butterfly that keeps
// half the entries at each of the first three levels: the sum of entry
// e = lane >> 2 comes back in every lane of group e (each sum's tree, and
// so its rounding, is the same in every run).
__device__ __forceinline__ float uw_sum8_scatter(const float (&v)[8], int lane) {
    const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4;
    float a[4], c[2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
        a[j] = (h4 ? v[4 + j] : v[j]) +
               __shfl_xor_sync(FULL_MASK, h4 ? v[j] : v[4 + j], 16);
#pragma unroll
    for (int j = 0; j < 2; ++j)
        c[j] = (h3 ? a[2 + j] : a[j]) +
               __shfl_xor_sync(FULL_MASK, h3 ? a[j] : a[2 + j], 8);
    float d = (h2 ? c[1] : c[0]) + __shfl_xor_sync(FULL_MASK, h2 ? c[0] : c[1], 4);
    d += __shfl_xor_sync(FULL_MASK, d, 2);
    d += __shfl_xor_sync(FULL_MASK, d, 1);
    return d;
}

// The 2x2 a mat step applies, complex: the step's matrix m (forward) or
// its inverse conj(m)^T (backward).
struct UwMat {
    float r[2][2], i[2][2];
};

// Matrix k of a sample's [2][K][4] bank in shared memory (re rows, then im
// rows): as it is for the forward, conj-transposed for the backward.
template <bool BWD>
__device__ __forceinline__ UwMat uw_matrix(const float* mt, int k, int K) {
    const float* m = mt + k * 4;
    UwMat a;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            a.r[i][j] = BWD ? m[2 * j + i] : m[2 * i + j];
            a.i[i][j] = BWD ? -m[4 * K + 2 * j + i] : m[4 * K + 2 * i + j];
        }
    return a;
}

// A mat step on register bit G: each lane updates its own pairs
// (r, r | 2^G); with CTRL, where the control bit gb of the pair's index
// (lane << RB) | r is 0 the pair keeps its values (and, backward, adds
// nothing). Backward (BWD) it recovers the state, accumulates mbar and
// pulls the cotangent back; forward it applies a to the state alone (qr,
// qi and acc untouched).
template <int RB, int G, bool CTRL, bool BWD>
__device__ __forceinline__ void uw_mat_reg(float (&sr)[1 << RB], float (&si)[1 << RB],
                                           float (&qr)[1 << RB], float (&qi)[1 << RB],
                                           const UwMat& a, int gb, int lane,
                                           float (&acc)[8]) {
    constexpr int R = 1 << RB;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        if (r & (1 << G)) continue;
        const int r1 = r | (1 << G);
        const bool on = !CTRL || ((((lane << RB) | r) >> gb) & 1);
        float x0r, x0i, x1r, x1i;
        cmadd2(a.r[0][0], a.i[0][0], sr[r], si[r], a.r[0][1], a.i[0][1], sr[r1], si[r1],
               x0r, x0i);
        cmadd2(a.r[1][0], a.i[1][0], sr[r], si[r], a.r[1][1], a.i[1][1], sr[r1], si[r1],
               x1r, x1i);
        if constexpr (BWD) {
            float h0r, h0i, h1r, h1i;
            const float g0r = qr[r], g0i = qi[r], g1r = qr[r1], g1i = qi[r1];
            cmadd2(a.r[0][0], a.i[0][0], g0r, g0i, a.r[0][1], a.i[0][1], g1r, g1i, h0r,
                   h0i);
            cmadd2(a.r[1][0], a.i[1][0], g0r, g0i, a.r[1][1], a.i[1][1], g1r, g1i, h1r,
                   h1i);
            acc[0] += on ? g0r * x0r + g0i * x0i : 0.f;
            acc[1] += on ? g0i * x0r - g0r * x0i : 0.f;
            acc[2] += on ? g0r * x1r + g0i * x1i : 0.f;
            acc[3] += on ? g0i * x1r - g0r * x1i : 0.f;
            acc[4] += on ? g1r * x0r + g1i * x0i : 0.f;
            acc[5] += on ? g1i * x0r - g1r * x0i : 0.f;
            acc[6] += on ? g1r * x1r + g1i * x1i : 0.f;
            acc[7] += on ? g1i * x1r - g1r * x1i : 0.f;
            qr[r] = on ? h0r : g0r;
            qi[r] = on ? h0i : g0i;
            qr[r1] = on ? h1r : g1r;
            qi[r1] = on ? h1i : g1i;
        }
        sr[r] = on ? x0r : sr[r];
        si[r] = on ? x0i : si[r];
        sr[r1] = on ? x1r : sr[r1];
        si[r1] = on ? x1i : si[r1];
    }
}

// A mat step on lane bit L: the pair of register r is (this lane, lane ^ 2^L).
// Each lane takes the partner's state (and cotangent) by shuffle and
// computes its own new amplitude; backward also the partner's recovered one
// (cheaper in registers than a second shuffle), and accumulates row h of
// mbar, h its own value of the bit.
template <int RB, bool CTRL, bool BWD>
__device__ __forceinline__ void uw_mat_lane(float (&sr)[1 << RB], float (&si)[1 << RB],
                                            float (&qr)[1 << RB], float (&qi)[1 << RB],
                                            const UwMat& a, int L, int gb, int lane,
                                            float (&acc)[8]) {
    constexpr int R = 1 << RB;
    const int h = (lane >> L) & 1, m = 1 << L;
    // x_h = a[h][h] y_own + a[h][o] y_oth;  x_o = a[o][h] y_own + a[o][o] y_oth
    const float csr = h ? a.r[1][1] : a.r[0][0], csi = h ? a.i[1][1] : a.i[0][0];
    const float cor = h ? a.r[1][0] : a.r[0][1], coi = h ? a.i[1][0] : a.i[0][1];
    if constexpr (BWD) {
        const float dsr = h ? a.r[0][1] : a.r[1][0], dsi = h ? a.i[0][1] : a.i[1][0];
        const float dor = h ? a.r[0][0] : a.r[1][1], doi = h ? a.i[0][0] : a.i[1][1];
        float pr = 0.f, pi = 0.f, tr = 0.f, ti = 0.f;  // mbar[h][h], mbar[h][o]
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const float yor = __shfl_xor_sync(FULL_MASK, sr[r], m);
            const float yoi = __shfl_xor_sync(FULL_MASK, si[r], m);
            const float gor = __shfl_xor_sync(FULL_MASK, qr[r], m);
            const float goi = __shfl_xor_sync(FULL_MASK, qi[r], m);
            const bool on = !CTRL || ((((lane << RB) | r) >> gb) & 1);
            float xr, xi, zr, zi, hr, hi;
            cmadd2(csr, csi, sr[r], si[r], cor, coi, yor, yoi, xr, xi);
            cmadd2(dsr, dsi, sr[r], si[r], dor, doi, yor, yoi, zr, zi);
            const float gr = qr[r], gi = qi[r];
            cmadd2(csr, csi, gr, gi, cor, coi, gor, goi, hr, hi);
            pr += on ? gr * xr + gi * xi : 0.f;
            pi += on ? gi * xr - gr * xi : 0.f;
            tr += on ? gr * zr + gi * zi : 0.f;
            ti += on ? gi * zr - gr * zi : 0.f;
            sr[r] = on ? xr : sr[r];
            si[r] = on ? xi : si[r];
            qr[r] = on ? hr : gr;
            qi[r] = on ? hi : gi;
        }
        // row h: entries 2 (2h + h) and 2 (2h + o)
        acc[0] += h ? 0.f : pr;
        acc[1] += h ? 0.f : pi;
        acc[2] += h ? 0.f : tr;
        acc[3] += h ? 0.f : ti;
        acc[4] += h ? tr : 0.f;
        acc[5] += h ? ti : 0.f;
        acc[6] += h ? pr : 0.f;
        acc[7] += h ? pi : 0.f;
    } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const float yor = __shfl_xor_sync(FULL_MASK, sr[r], m);
            const float yoi = __shfl_xor_sync(FULL_MASK, si[r], m);
            const bool on = !CTRL || ((((lane << RB) | r) >> gb) & 1);
            float xr, xi;
            cmadd2(csr, csi, sr[r], si[r], cor, coi, yor, yoi, xr, xi);
            sr[r] = on ? xr : sr[r];
            si[r] = on ? xi : si[r];
        }
    }
}

// The step's target bit picks the code (a register bit G, or a lane bit),
// its control bit whether the pairs select.
template <int RB, bool CTRL, bool BWD, int G = 0>
__device__ __forceinline__ void uw_mat(float (&sr)[1 << RB], float (&si)[1 << RB],
                                       float (&qr)[1 << RB], float (&qi)[1 << RB],
                                       const UwMat& a, int ga, int gb, int lane,
                                       float (&acc)[8]) {
    if constexpr (G == RB) {
        uw_mat_lane<RB, CTRL, BWD>(sr, si, qr, qi, a, ga - RB, gb, lane, acc);
    } else {
        if (ga == G)
            uw_mat_reg<RB, G, CTRL, BWD>(sr, si, qr, qi, a, gb, lane, acc);
        else
            uw_mat<RB, CTRL, BWD, G + 1>(sr, si, qr, qi, a, ga, gb, lane, acc);
    }
}

// One quad (base register r) of a u2q step on one plane pair: gather the
// four entries (by shuffle where a bit is a lane bit), apply the rows w,
// keep the entries this lane holds.
template <int RB, int GA, int GB>
__device__ __forceinline__ void uw_quad(float (&vr)[1 << RB], float (&vi)[1 << RB], int r,
                                        const float (&wr)[4][4], const float (&wi)[4][4],
                                        const int (&src)[4], const bool (&own)[4]) {
    constexpr int MA = GA >= 0 ? 1 << GA : 0, MB = GB >= 0 ? 1 << GB : 0;
    float ar[4], ai[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const int re = r | ((e >> 1) ? MA : 0) | ((e & 1) ? MB : 0);
        if (GA >= 0 && GB >= 0) {
            ar[e] = vr[re];
            ai[e] = vi[re];
        } else {
            ar[e] = __shfl_sync(FULL_MASK, vr[re], src[e]);
            ai[e] = __shfl_sync(FULL_MASK, vi[re], src[e]);
        }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const int re = r | ((e >> 1) ? MA : 0) | ((e & 1) ? MB : 0);
        float accr = 0.f, acci = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            accr = fmaf(wr[e][c], ar[c], fmaf(-wi[e][c], ai[c], accr));
            acci = fmaf(wr[e][c], ai[c], fmaf(wi[e][c], ar[c], acci));
        }
        vr[re] = own[e] ? accr : vr[re];
        vi[re] = own[e] ? acci : vi[re];
    }
}

// A fixed 4x4 on bits (a, b), entries in (bit a, bit b) order: U on the
// state (forward), or its inverse conj(U)^T on the state and the cotangent
// (BWD). GA, GB: the register bit of a and of b, or -1 for a lane bit (la,
// lb). u: the 4x4's [32] row in shared memory.
template <int RB, int GA, int GB, bool BWD>
__device__ __forceinline__ void uw_u2q_apply(float (&sr)[1 << RB], float (&si)[1 << RB],
                                             float (&qr)[1 << RB], float (&qi)[1 << RB],
                                             const float* u, int la, int lb, int lane) {
    constexpr int R = 1 << RB;
    constexpr int MA = GA >= 0 ? 1 << GA : 0, MB = GB >= 0 ? 1 << GB : 0;
    float wr[4][4], wi[4][4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int k = BWD ? (c * 4 + e) * 2 : (e * 4 + c) * 2;
            wr[e][c] = u[k];
            wi[e][c] = BWD ? -u[k + 1] : u[k + 1];
        }
    const int oa = GA >= 0 ? 0 : (lane >> la) & 1;
    const int ob = GB >= 0 ? 0 : (lane >> lb) & 1;
    int src[4];
    bool own[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        int s = lane;
        if (GA < 0) s = (s & ~(1 << la)) | ((e >> 1) << la);
        if (GB < 0) s = (s & ~(1 << lb)) | ((e & 1) << lb);
        src[e] = s;
        own[e] = (GA >= 0 || (e >> 1) == oa) && (GB >= 0 || (e & 1) == ob);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
        if (r & (MA | MB)) continue;
        uw_quad<RB, GA, GB>(sr, si, r, wr, wi, src, own);
        if constexpr (BWD) uw_quad<RB, GA, GB>(qr, qi, r, wr, wi, src, own);
    }
}

template <int RB, bool BWD, int GA, int GB = 0>
__device__ __forceinline__ void uw_u2q_b(float (&sr)[1 << RB], float (&si)[1 << RB],
                                         float (&qr)[1 << RB], float (&qi)[1 << RB],
                                         const float* u, int ga, int gb, int lane) {
    if constexpr (GB == RB) {
        uw_u2q_apply<RB, GA, -1, BWD>(sr, si, qr, qi, u, ga - RB, gb - RB, lane);
    } else {
        if (gb == GB)
            uw_u2q_apply<RB, GA, GB, BWD>(sr, si, qr, qi, u, ga - RB, gb - RB, lane);
        else
            uw_u2q_b<RB, BWD, GA, GB + 1>(sr, si, qr, qi, u, ga, gb, lane);
    }
}

template <int RB, bool BWD, int GA = 0>
__device__ __forceinline__ void uw_u2q(float (&sr)[1 << RB], float (&si)[1 << RB],
                                       float (&qr)[1 << RB], float (&qi)[1 << RB],
                                       const float* u, int ga, int gb, int lane) {
    if constexpr (GA == RB) {
        uw_u2q_b<RB, BWD, -1>(sr, si, qr, qi, u, ga, gb, lane);
    } else {
        if (ga == GA)
            uw_u2q_b<RB, BWD, GA>(sr, si, qr, qi, u, ga, gb, lane);
        else
            uw_u2q<RB, BWD, GA + 1>(sr, si, qr, qi, u, ga, gb, lane);
    }
}

// The CTA's copy of the [P][D] phase rows (cos, then sin) and the [U][32]
// 4x4s, staged once before any sweep; the caller's barrier publishes it.
__device__ __forceinline__ void uw_stage_banks(const float* __restrict__ cosb,
                                               const float* __restrict__ sinb,
                                               const float* __restrict__ u4, float* pcos,
                                               float* psin, float* pu4, size_t PD, int U) {
    for (size_t e = threadIdx.x; e < PD; e += blockDim.x) {
        pcos[e] = cosb[e];
        psin[e] = sinb[e];
    }
    for (int e = threadIdx.x; e < 32 * U; e += blockDim.x) pu4[e] = u4[e];
}

// K3's warp route. Shared memory a CTA of W warps: per warp the sample's
// [2][K][4] matrices (8K floats), then the CTA's copy of the phase rows
// (2 P D) and of the 4x4s (32 U); qc_unrolled_fwd_warp and
// sv_kernel.warp_smem compute the same.
template <int RB>
__device__ __forceinline__ void unrolled_fwd_warp_body(
    const float* __restrict__ xr, const float* __restrict__ xi,
    const float* __restrict__ mre, const float* __restrict__ mim,
    const float* __restrict__ cosb, const float* __restrict__ sinb,
    const float* __restrict__ u4, float* __restrict__ yr, float* __restrict__ yi, int B,
    int n, int K, int P, int U, const GtTable& tab) {
    constexpr int R = 1 << RB;
    extern __shared__ float smem[];
    const int D = 1 << n;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int W = blockDim.x >> 5;
    float* mt = smem + (size_t)warp * 8 * K;   // the sample's [2][K][4] bank
    float* pcos = smem + (size_t)W * 8 * K;    // [P][D], then sin's
    float* psin = pcos + (size_t)P * D;
    float* pu4 = psin + (size_t)P * D;         // [U][32]
    uw_stage_banks(cosb, sinb, u4, pcos, psin, pu4, (size_t)P * D, U);
    const int base = lane * R;                  // this lane's first index
    const bool live = base < D;                 // false beyond 2^n (n < 5)
    float acc[8];                               // unused forward
    __syncthreads();  // the CTA's phase rows and 4x4s

    for (int b = blockIdx.x * W + warp; b < B; b += gridDim.x * W) {
        const size_t row = (size_t)b * D + base;
        float sr[R], si[R];
#pragma unroll
        for (int r = 0; r < R; ++r) sr[r] = si[r] = 0.f;
        if (live) {
            uw_load<R>(xr + row, sr);
            uw_load<R>(xi + row, si);
        }
        for (int e = lane; e < 4 * K; e += 32) {
            mt[e] = __ldg(mre + (size_t)b * 4 * K + e);
            mt[4 * K + e] = __ldg(mim + (size_t)b * 4 * K + e);
        }
        __syncwarp();
        for (int k = 0; k < tab.n_steps; ++k) {
            const GtStep st = decode(tab.step[k]);
            if (st.kind == 0) {
                const UwMat a = uw_matrix<false>(mt, st.idx, K);
                if (st.ctrl)
                    uw_mat<RB, true, false>(sr, si, sr, si, a, st.ga, st.gb, lane, acc);
                else
                    uw_mat<RB, false, false>(sr, si, sr, si, a, st.ga, st.gb, lane, acc);
            } else if (st.kind == 1) {
                float c[R], s[R];
#pragma unroll
                for (int r = 0; r < R; ++r) c[r] = s[r] = 0.f;
                if (live) {
                    uw_load<R>(pcos + (size_t)st.idx * D + base, c);
                    uw_load<R>(psin + (size_t)st.idx * D + base, s);
                }
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const float a = sr[r], d = si[r];
                    sr[r] = fmaf(a, c[r], -d * s[r]);
                    si[r] = fmaf(a, s[r], d * c[r]);
                }
            } else {
                uw_u2q<RB, false>(sr, si, sr, si, pu4 + 32 * st.idx, st.ga, st.gb, lane);
            }
        }
        if (live) {
            uw_store<R>(yr + row, sr);
            uw_store<R>(yi + row, si);
        }
        __syncwarp();  // the sample's matrices are read before the next load
    }
}

// K4's warp route. Shared memory a CTA of W warps: per warp 8K floats of
// matrix cotangents and 8K of the sample's matrices, then per warp 2 P D
// of phase cotangents, then the CTA's copy of the phase rows (2 P D) and
// of the 4x4s (32 U); qc_unrolled_bwd_warp and sv_kernel.warp_smem
// compute the same.
template <int RB>
__device__ __forceinline__ void unrolled_bwd_warp_body(
    const float* __restrict__ yr, const float* __restrict__ yi,
    const float* __restrict__ gr, const float* __restrict__ gi,
    const float* __restrict__ mre, const float* __restrict__ mim,
    const float* __restrict__ cosb, const float* __restrict__ sinb,
    const float* __restrict__ u4, float* __restrict__ gxr, float* __restrict__ gxi,
    float* __restrict__ gmre, float* __restrict__ gmim, float* __restrict__ partials,
    int B, int n, int K, int P, int U, const GtTable& tab) {
    constexpr int R = 1 << RB;
    extern __shared__ float smem[];
    const int D = 1 << n;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int W = blockDim.x >> 5;
    const size_t slab = (size_t)2 * P * D;
    float* mb = smem + (size_t)warp * 16 * K;       // [2][K][4]: re, then im
    float* mt = mb + 8 * K;                         // the sample's [2][K][4] bank
    float* ph0 = smem + (size_t)W * 16 * K;         // [W][2][P][D]
    float* ph = ph0 + (size_t)warp * slab;
    float* pcos = ph0 + (size_t)W * slab;           // [P][D], then sin's
    float* psin = pcos + (size_t)P * D;
    float* pu4 = psin + (size_t)P * D;              // [U][32]
    uw_stage_banks(cosb, sinb, u4, pcos, psin, pu4, (size_t)P * D, U);
    const int base = lane * R;                       // this lane's first index
    const bool live = base < D;                      // false beyond 2^n (n < 5)
    float pc[UW_PHASE_REGS][R], ps[UW_PHASE_REGS][R];
#pragma unroll
    for (int p = 0; p < UW_PHASE_REGS; ++p)
#pragma unroll
        for (int r = 0; r < R; ++r) pc[p][r] = ps[p][r] = 0.f;
    if (live)
        for (int p = UW_PHASE_REGS; p < P; ++p)
#pragma unroll
            for (int r = 0; r < R; ++r)
                ph[(size_t)p * D + base + r] = ph[(size_t)(P + p) * D + base + r] = 0.f;
    for (int e = lane; e < 8 * K; e += 32) mb[e] = 0.f;
    __syncthreads();  // the CTA's phase rows and 4x4s

    for (int b = blockIdx.x * W + warp; b < B; b += gridDim.x * W) {
        const size_t row = (size_t)b * D + base;
        float sr[R], si[R], qr[R], qi[R];
#pragma unroll
        for (int r = 0; r < R; ++r) sr[r] = si[r] = qr[r] = qi[r] = 0.f;
        if (live) {
            uw_load<R>(yr + row, sr);
            uw_load<R>(yi + row, si);
            uw_load<R>(gr + row, qr);
            uw_load<R>(gi + row, qi);
        }
        // the sample's matrices, all at once: a mat step then waits on
        // shared memory, not on device memory
        for (int e = lane; e < 4 * K; e += 32) {
            mt[e] = __ldg(mre + (size_t)b * 4 * K + e);
            mt[4 * K + e] = __ldg(mim + (size_t)b * 4 * K + e);
        }
        __syncwarp();
        for (int k = tab.n_steps - 1; k >= 0; --k) {
            const GtStep st = decode(tab.step[k]);
            if (st.kind == 0) {
                const UwMat a = uw_matrix<true>(mt, st.idx, K);
                float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
                if (st.ctrl)
                    uw_mat<RB, true, true>(sr, si, qr, qi, a, st.ga, st.gb, lane, acc);
                else
                    uw_mat<RB, false, true>(sr, si, qr, qi, a, st.ga, st.gb, lane, acc);
                const float v = uw_sum8_scatter(acc, lane);
                if ((lane & 3) == 0) {
                    const int e = lane >> 2;  // entry 2 (2i + j) + (re, im)
                    mb[(e & 1) * 4 * K + st.idx * 4 + (e >> 1)] += v;
                }
            } else if (st.kind == 1) {
                float c[R], s[R];
#pragma unroll
                for (int r = 0; r < R; ++r) c[r] = s[r] = 0.f;
                if (live) {
                    uw_load<R>(pcos + (size_t)st.idx * D + base, c);
                    uw_load<R>(psin + (size_t)st.idx * D + base, s);
                }
                float gc[R], gs[R];
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    // input recovery: conjugate phase
                    const float a = fmaf(c[r], sr[r], s[r] * si[r]);
                    const float d = fmaf(c[r], si[r], -s[r] * sr[r]);
                    sr[r] = a;
                    si[r] = d;
                    const float u = qr[r], v = qi[r];
                    // phase cotangents (out = (c + i s) * in)
                    gc[r] = u * a + v * d;
                    gs[r] = -u * d + v * a;
                    qr[r] = fmaf(c[r], u, s[r] * v);
                    qi[r] = fmaf(c[r], v, -s[r] * u);
                }
                if (st.idx < UW_PHASE_REGS) {
#pragma unroll
                    for (int p = 0; p < UW_PHASE_REGS; ++p)
                        if (st.idx == p)
#pragma unroll
                            for (int r = 0; r < R; ++r) {
                                pc[p][r] += gc[r];
                                ps[p][r] += gs[r];
                            }
                } else if (live) {
                    float* pcs = ph + (size_t)st.idx * D + base;
                    float* pss = ph + (size_t)(P + st.idx) * D + base;
#pragma unroll
                    for (int r = 0; r < R; ++r) {
                        pcs[r] += gc[r];
                        pss[r] += gs[r];
                    }
                }
            } else {
                uw_u2q<RB, true>(sr, si, qr, qi, pu4 + 32 * st.idx, st.ga, st.gb, lane);
            }
        }
        if (live) {
            uw_store<R>(gxr + row, qr);
            uw_store<R>(gxi + row, qi);
        }
        __syncwarp();
        for (int e = lane; e < 4 * K; e += 32) {
            gmre[(size_t)b * 4 * K + e] = mb[e];
            gmim[(size_t)b * 4 * K + e] = mb[4 * K + e];
        }
        __syncwarp();
        for (int e = lane; e < 8 * K; e += 32) mb[e] = 0.f;
        __syncwarp();
    }

    // the CTA's slab: its warps' phase cotangents added in warp order
    if (live)
#pragma unroll
        for (int p = 0; p < UW_PHASE_REGS; ++p)
            if (p < P)
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    ph[(size_t)p * D + base + r] = pc[p][r];
                    ph[(size_t)(P + p) * D + base + r] = ps[p][r];
                }
    __syncthreads();
    float* out = partials + (size_t)blockIdx.x * slab;
    for (size_t e = threadIdx.x; e < slab; e += blockDim.x) {
        float acc = 0.f;
        for (int w = 0; w < W; ++w) acc += ph0[(size_t)w * slab + e];
        out[e] = acc;
    }
}

#define UW_KERNEL(RB)                                                                  \
    extern "C" __global__ void __launch_bounds__(UW_MAX_WARPS * 32)                   \
        unrolled_bwd_warp_kernel_rb##RB(                                               \
            const float* __restrict__ yr, const float* __restrict__ yi,                \
            const float* __restrict__ gr, const float* __restrict__ gi,                \
            const float* __restrict__ mre, const float* __restrict__ mim,              \
            const float* __restrict__ cosb, const float* __restrict__ sinb,            \
            const float* __restrict__ u4, float* __restrict__ gxr,                     \
            float* __restrict__ gxi, float* __restrict__ gmre,                         \
            float* __restrict__ gmim, float* __restrict__ partials, int B, int n,      \
            int K, int P, int U, GtTable tab) {                                        \
        unrolled_bwd_warp_body<RB>(yr, yi, gr, gi, mre, mim, cosb, sinb, u4, gxr, gxi, \
                                   gmre, gmim, partials, B, n, K, P, U, tab);          \
    }                                                                                  \
    extern "C" __global__ void __launch_bounds__(UW_MAX_WARPS * 32)                   \
        unrolled_fwd_warp_kernel_rb##RB(                                               \
            const float* __restrict__ xr, const float* __restrict__ xi,                \
            const float* __restrict__ mre, const float* __restrict__ mim,              \
            const float* __restrict__ cosb, const float* __restrict__ sinb,            \
            const float* __restrict__ u4, float* __restrict__ yr,                      \
            float* __restrict__ yi, int B, int n, int K, int P, int U, GtTable tab) {  \
        unrolled_fwd_warp_body<RB>(xr, xi, mre, mim, cosb, sinb, u4, yr, yi, B, n, K,  \
                                   P, U, tab);                                         \
    }
UW_KERNEL(0)
UW_KERNEL(1)
UW_KERNEL(2)
UW_KERNEL(3)
UW_KERNEL(4)

// -- K3/K4 for 10 <= n <= 12: the tiled sweep over segments ------------------
//
// One CTA holds a sample in shared memory (its state, and backward its
// cotangent: 4 * 2^n floats, 64 KB at 12 qubits) and walks the program's
// segments, forward in order, backward in reverse. A segment is a maximal
// run of steps whose target bits (a mat's ga, a u2q's ga and gb; a diag
// has none and joins any segment) fit in US_TILE_BITS = 3 bits S, padded
// with the highest other bits to exactly 3. Each of the CTA's 2^(n-3)
// threads loads a tile of 8 amplitudes that differ only in S (of every
// plane) into registers, applies the segment's steps there with the warp
// route's register-bit code (its tile is the warp route's R = 8
// registers; a control bit outside S is the same for the whole tile),
// stores the tile, and the CTA meets one barrier a segment, not one a
// step. The 10q evolve's 25 steps are 9 segments.
//
// Thread t's tile base deposits t's bits on the bits outside S: lane bits
// first, then the warp's. Amplitude i lives at i ^ sw(i) in shared memory,
// sw(i) = bits 5-9 of i, xor 31 for each of bits 10 and 11 that is set, so
// a lane bit p contributes e_p (p < 5), e_(p-5) (p < 10) or 11111 to the
// bank. The lanes take, for each residue r < 5, bit r or else bit r + 5
// (whichever is outside S), and bit 10 or 11 where both are in S, so every
// tile load and store of a warp hits 32 banks (sv_kernel.tile_layout
// mirrors the rule, and the tests hold it conflict-free). The phase rows
// and the backward's phase-cotangent slab use the same layout.
//
// Nothing in the sweep reads device memory: the sample's [2][K][4]
// matrices come into shared memory with its state, the phase rows (2 P D
// floats; through __ldg where the budget does not allow them: ROWS) and
// the 4x4s once a CTA. Backward, a mat step's 8 partial sums of each
// thread go through the warp's butterfly (uw_sum8_scatter) into the warp's
// row of [W][K][8] in shared memory; after the sweep the CTA adds the rows
// in warp order and writes the sample's matrix cotangents once (no zeroing
// pass, no read-modify-write in device memory). The phase cotangents
// accumulate over the CTA's samples in a [2][P][D] slab in shared memory
// (each index added by one thread a step, in step and sample order; SLAB)
// or, where it does not fit, in the CTA's row of `partials`; the slab sum
// (K4b) adds the CTA's slabs. No float atomics.
//
// What bounds it on the H100 at the 10q main path's batches (a CTA a
// sample, 3-4 CTAs of 4 warps an SM): latency, not issue or bandwidth. A
// mat step costs about 1 us backward and 0.45 us forward, a segment's
// loads, stores and barrier 1.5-2 us (PERF.md, chip_smoke.py
// --unrolled-step-costs), both far above their instruction counts.

#define US_TILE_BITS 3
#define US_TILE (1 << US_TILE_BITS)

// Where amplitude i lives in shared memory (an involution: sw reads only
// bits >= 5, which the xor leaves alone).
__device__ __forceinline__ int us_phys(int i) {
    return i ^ (((i >> 5) & 31) ^ (-(((i >> 10) ^ (i >> 11)) & 1) & 31));
}

// Thread 0 lays out the table once a CTA, in shared memory (the host marks
// each segment's last step with US_SEG_END; the table's last step always
// is). A segment's layout is 8 words: [0] first step | end step << 16 (the
// run [first, end) of the table); [1], [2] the bits outside S in the order
// thread t's bits are deposited on them (lanes first), 4 bits each;
// [3] unused; [4..8) the tile's 8 physical offsets us_phys(o_j), o_j the
// tile bits of j, 16 bits each. sv_kernel.tile_layout is the same rule.
// A step's local word (one a step, so no step decodes its table word in
// the sweep): kind[0:2] | l[2:4] (a mat's target, a u2q's bit a, as tile
// register bits) | x[4:6] (a u2q's bit b; a mat's control as a tile
// register bit, or US_TILE_BITS where it lies outside S) | ctrl[6] |
// gb[7:11] (a mat's control bit) | idx[16:32].
__device__ void us_layout(int first, int end, unsigned mask, int n, const GtTable& tab,
                          unsigned* seg, unsigned* lstep) {
    for (int g = n - 1; g >= 0 && __popc(mask) < US_TILE_BITS; --g) mask |= 1u << g;
    int tb[US_TILE_BITS];
    for (int g = 0, q = 0; g < n; ++g)
        if ((mask >> g) & 1) tb[q++] = g;
    seg[0] = (unsigned)first | ((unsigned)end << 16);
    unsigned long long tp = 0;
    int q = 0, missing = 0;
    unsigned used = mask;
    for (int r = 0; r < 5; ++r) {
        int pick = -1;
        if (r < n && !((used >> r) & 1))
            pick = r;
        else if (r + 5 < n && !((used >> (r + 5)) & 1))
            pick = r + 5;
        if (pick < 0) {
            ++missing;
            continue;
        }
        used |= 1u << pick;
        tp |= (unsigned long long)pick << (4 * q++);
    }
    for (; missing > 0; --missing) {
        int pick = -1;
        for (int g = 10; g < 12 && pick < 0; ++g)
            if (g < n && !((used >> g) & 1)) pick = g;
        for (int g = 0; g < n && pick < 0; ++g)
            if (!((used >> g) & 1)) pick = g;
        if (pick < 0) break;
        used |= 1u << pick;
        tp |= (unsigned long long)pick << (4 * q++);
    }
    for (int g = 0; g < n; ++g)
        if (!((used >> g) & 1)) tp |= (unsigned long long)g << (4 * q++);
    seg[1] = (unsigned)tp;
    seg[2] = (unsigned)(tp >> 32);
    seg[3] = 0;
    for (int j = 0; j < US_TILE; j += 2) {
        int o0 = 0, o1 = 0;
        for (int b = 0; b < US_TILE_BITS; ++b) {
            o0 |= ((j >> b) & 1) << tb[b];
            o1 |= (((j + 1) >> b) & 1) << tb[b];
        }
        seg[4 + j / 2] = (unsigned)us_phys(o0) | ((unsigned)us_phys(o1) << 16);
    }
    for (int k = first; k < end; ++k) {
        const GtStep st = decode(tab.step[k]);
        int l = 0, x = US_TILE_BITS;
        for (int b = 0; b < US_TILE_BITS; ++b) {
            if (st.kind != 1 && st.ga == tb[b]) l = b;
            if ((st.kind == 2 || st.ctrl) && st.gb == tb[b]) x = b;
        }
        lstep[k] = (unsigned)st.kind | ((unsigned)l << 2) | ((unsigned)x << 4) |
                   ((unsigned)st.ctrl << 6) | ((unsigned)(st.gb & 15) << 7) |
                   ((unsigned)st.idx << 16);
    }
}

__device__ void us_segments(const GtTable& tab, int n, unsigned* seg, unsigned* lstep) {
    int s = 0, first = 0;
    unsigned mask = 0;
    for (int k = 0; k < tab.n_steps; ++k) {
        const GtStep st = decode(tab.step[k]);
        if (st.kind == 0) mask |= 1u << st.ga;
        if (st.kind == 2) mask |= (1u << st.ga) | (1u << st.gb);
        if (tab.step[k] & US_SEG_END) {
            us_layout(first, k + 1, mask, n, tab, seg + 8 * s++, lstep);
            first = k + 1;
            mask = 0;
        }
    }
}

template <bool BWD, int G = 0>
__device__ __forceinline__ void us_mat(float (&sr)[US_TILE], float (&si)[US_TILE],
                                       float (&qr)[US_TILE], float (&qi)[US_TILE],
                                       const UwMat& a, int l, bool ctrl, int vgb, int vlane,
                                       float (&acc)[8]) {
    if constexpr (G == US_TILE_BITS - 1) {
        if (ctrl)
            uw_mat_reg<US_TILE_BITS, G, true, BWD>(sr, si, qr, qi, a, vgb, vlane, acc);
        else
            uw_mat_reg<US_TILE_BITS, G, false, BWD>(sr, si, qr, qi, a, vgb, vlane, acc);
    } else {
        if (l == G) {
            if (ctrl)
                uw_mat_reg<US_TILE_BITS, G, true, BWD>(sr, si, qr, qi, a, vgb, vlane, acc);
            else
                uw_mat_reg<US_TILE_BITS, G, false, BWD>(sr, si, qr, qi, a, vgb, vlane, acc);
        } else {
            us_mat<BWD, G + 1>(sr, si, qr, qi, a, l, ctrl, vgb, vlane, acc);
        }
    }
}

template <bool BWD, int GA = 0, int GB = 0>
__device__ __forceinline__ void us_u2q(float (&sr)[US_TILE], float (&si)[US_TILE],
                                       float (&qr)[US_TILE], float (&qi)[US_TILE],
                                       const float* u, int la, int lb) {
    if constexpr (GA == US_TILE_BITS) {
        return;
    } else if constexpr (GB == US_TILE_BITS) {
        us_u2q<BWD, GA + 1, 0>(sr, si, qr, qi, u, la, lb);
    } else if constexpr (GA == GB) {
        us_u2q<BWD, GA, GB + 1>(sr, si, qr, qi, u, la, lb);
    } else {
        if (la == GA && lb == GB)
            uw_u2q_apply<US_TILE_BITS, GA, GB, BWD>(sr, si, qr, qi, u, 0, 0, 0);
        else
            us_u2q<BWD, GA, GB + 1>(sr, si, qr, qi, u, la, lb);
    }
}

// Shared memory of the tile route, in this order (sv_kernel.tile_smem
// computes the same): the segments' layouts (8 words each) and the steps'
// local words (one each), the sample's
// planes (BWD: state and cotangent, 4 D; else 2 D), its [2][K][4]
// matrices, the phase rows (ROWS: 2 P D), the phase-cotangent slab (BWD
// and SLAB: 2 P D), the warps' matrix-cotangent rows (BWD: [W][K][8]) and
// the [U][32] 4x4s.
template <bool BWD, bool ROWS, bool SLAB>
__device__ __forceinline__ void unrolled_tile_body(
    const float* __restrict__ xr, const float* __restrict__ xi,
    const float* __restrict__ gr, const float* __restrict__ gi,
    const float* __restrict__ mre, const float* __restrict__ mim,
    const float* __restrict__ cosb, const float* __restrict__ sinb,
    const float* __restrict__ u4, float* __restrict__ outr, float* __restrict__ outi,
    float* __restrict__ gmre, float* __restrict__ gmim, float* __restrict__ partials,
    int B, int n, int K, int P, int U, int n_seg, const GtTable& tab) {
    constexpr int PL = BWD ? 4 : 2;
    extern __shared__ float smem[];
    const int D = 1 << n;
    const int tid = threadIdx.x, T = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5, W = T >> 5;
    const size_t PD = (size_t)P * D;
    unsigned* seg = reinterpret_cast<unsigned*>(smem);  // [n_seg][8]
    unsigned* lstep = seg + 8 * n_seg;               // [n_steps]
    float* sp = smem + 8 * (size_t)n_seg + tab.n_steps;  // [PL][D], swizzled
    float* mt = sp + (size_t)PL * D;                // [2][K][4]
    float* rows = mt + 8 * (size_t)K;               // ROWS: [2][P][D], swizzled
    float* slab = rows + (ROWS ? 2 * PD : 0);       // BWD && SLAB: [2][P][D], swizzled
    float* mrow = slab + (BWD && SLAB ? 2 * PD : 0);  // BWD: [W][K][8]
    float* pu4 = mrow + (BWD ? (size_t)W * 8 * K : 0);  // [U][32]
    float* gslab = partials + (size_t)blockIdx.x * 2 * PD;  // BWD && !SLAB

    if (tid == 0) us_segments(tab, n, seg, lstep);
    for (int e = tid; e < 32 * U; e += T) pu4[e] = u4[e];
    if constexpr (ROWS)
        for (int r = 0; r < P; ++r) {  // a row a round: every load, then the stores
            float c[US_TILE], s[US_TILE];
#pragma unroll
            for (int j = 0; j < US_TILE; ++j) {
                c[j] = __ldg(cosb + (size_t)r * D + tid + j * T);
                s[j] = __ldg(sinb + (size_t)r * D + tid + j * T);
            }
#pragma unroll
            for (int j = 0; j < US_TILE; ++j) {
                const size_t o = (size_t)r * D + us_phys(tid + j * T);
                rows[o] = c[j];
                rows[PD + o] = s[j];
            }
        }
    if constexpr (BWD) {
        for (size_t e = tid; e < 2 * PD; e += T) (SLAB ? slab : gslab)[e] = 0.f;
        for (int e = tid; e < W * 8 * K; e += T) mrow[e] = 0.f;
    }

    for (int b = blockIdx.x; b < B; b += gridDim.x) {
        const size_t row = (size_t)b * D;
        {  // D = 8 T: 8 amplitudes of every plane a thread, all loads in flight
            float v[PL][US_TILE];
#pragma unroll
            for (int j = 0; j < US_TILE; ++j) {
                const size_t e = row + tid + j * T;
                v[0][j] = __ldg(xr + e);
                v[1][j] = __ldg(xi + e);
                if constexpr (BWD) {
                    v[2][j] = __ldg(gr + e);
                    v[3][j] = __ldg(gi + e);
                }
            }
#pragma unroll
            for (int j = 0; j < US_TILE; ++j)
#pragma unroll
                for (int q = 0; q < PL; ++q) sp[q * D + us_phys(tid + j * T)] = v[q][j];
        }
        for (int e = tid; e < 4 * K; e += T) {
            mt[e] = __ldg(mre + (size_t)b * 4 * K + e);
            mt[4 * K + e] = __ldg(mim + (size_t)b * 4 * K + e);
        }
        __syncthreads();  // the sample (and before the first, the layouts)

        for (int si_ = 0; si_ < n_seg; ++si_) {
            const unsigned* d = seg + 8 * (BWD ? n_seg - 1 - si_ : si_);
            const uint4 d0 = *reinterpret_cast<const uint4*>(d);
            const uint4 d1 = *reinterpret_cast<const uint4*>(d + 4);
            const int first = (int)(d0.x & 0xffffu), end = (int)(d0.x >> 16);
            int base = 0;
            for (int q = 0; q < n - US_TILE_BITS; ++q) {
                const unsigned pos = q < 8 ? d0.y >> (4 * q) : d0.z >> (4 * (q - 8));
                base |= ((tid >> q) & 1) << (pos & 15u);
            }
            const int pb = us_phys(base);
            // the tile's physical offsets from pb
            const int po[US_TILE] = {(int)(d1.x & 0xffffu), (int)(d1.x >> 16),
                                     (int)(d1.y & 0xffffu), (int)(d1.y >> 16),
                                     (int)(d1.z & 0xffffu), (int)(d1.z >> 16),
                                     (int)(d1.w & 0xffffu), (int)(d1.w >> 16)};
            float sr[US_TILE], si[US_TILE], qr[US_TILE], qi[US_TILE];
#pragma unroll
            for (int j = 0; j < US_TILE; ++j) {
                sr[j] = sp[pb ^ po[j]];
                si[j] = sp[D + (pb ^ po[j])];
                if constexpr (BWD) {
                    qr[j] = sp[2 * D + (pb ^ po[j])];
                    qi[j] = sp[3 * D + (pb ^ po[j])];
                } else {
                    qr[j] = qi[j] = 0.f;
                }
            }
            for (int kk = 0; kk < end - first; ++kk) {
                const int k = BWD ? end - 1 - kk : first + kk;
                const unsigned w = lstep[k];
                const int kind = (int)(w & 3u), idx = (int)(w >> 16);
                const int l = (int)((w >> 2) & 3u), x = (int)((w >> 4) & 3u);
                if (kind == 0) {
                    const UwMat a = uw_matrix<BWD>(mt, idx, K);
                    // a control bit in S selects by register, else the
                    // whole tile shares the base's bit
                    const bool ctrl = (w >> 6) & 1u;
                    const int vlane = x == US_TILE_BITS ? (base >> ((w >> 7) & 15u)) & 1 : 0;
                    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
                    us_mat<BWD>(sr, si, qr, qi, a, l, ctrl, x, vlane, acc);
                    if constexpr (BWD) {
                        const float v = uw_sum8_scatter(acc, lane);
                        if ((lane & 3) == 0)
                            mrow[((size_t)warp * K + idx) * 8 + (lane >> 2)] += v;
                    }
                } else if (kind == 1) {
                    const size_t ro = (size_t)idx * D;
#pragma unroll
                    for (int j = 0; j < US_TILE; ++j) {
                        const int p = pb ^ po[j];
                        float c, s;
                        if constexpr (ROWS) {
                            c = rows[ro + p];
                            s = rows[PD + ro + p];
                        } else {
                            c = __ldg(cosb + ro + us_phys(p));
                            s = __ldg(sinb + ro + us_phys(p));
                        }
                        if constexpr (BWD) {
                            // input recovery: conjugate phase
                            const float a = fmaf(c, sr[j], s * si[j]);
                            const float dd = fmaf(c, si[j], -s * sr[j]);
                            sr[j] = a;
                            si[j] = dd;
                            const float u = qr[j], v = qi[j];
                            // phase cotangents (out = (c + i s) * in)
                            float* gc = SLAB ? slab + ro + p : gslab + ro + us_phys(p);
                            gc[0] += u * a + v * dd;
                            gc[PD] += -u * dd + v * a;
                            qr[j] = fmaf(c, u, s * v);
                            qi[j] = fmaf(c, v, -s * u);
                        } else {
                            const float a = sr[j], dd = si[j];
                            sr[j] = fmaf(a, c, -dd * s);
                            si[j] = fmaf(a, s, dd * c);
                        }
                    }
                } else {
                    us_u2q<BWD>(sr, si, qr, qi, pu4 + 32 * idx, l, x);
                }
            }
#pragma unroll
            for (int j = 0; j < US_TILE; ++j) {
                sp[pb ^ po[j]] = sr[j];
                sp[D + (pb ^ po[j])] = si[j];
                if constexpr (BWD) {
                    sp[2 * D + (pb ^ po[j])] = qr[j];
                    sp[3 * D + (pb ^ po[j])] = qi[j];
                }
            }
            __syncthreads();
        }

        const float* res = sp + (BWD ? 2 * D : 0);
#pragma unroll
        for (int j = 0; j < US_TILE; ++j) {
            const int e = tid + j * T, p = us_phys(e);
            outr[row + e] = res[p];
            outi[row + e] = res[D + p];
        }
        if constexpr (BWD) {
            // the sample's matrix cotangents: the warps' rows in warp order
            for (int e = tid; e < 8 * K; e += T) {
                float acc = 0.f;
                for (int w = 0; w < W; ++w) {
                    acc += mrow[(size_t)w * 8 * K + e];
                    mrow[(size_t)w * 8 * K + e] = 0.f;
                }
                const int k = e >> 3, c = e & 7;  // entry 2 (2i + j) + (re, im)
                ((c & 1) ? gmim : gmre)[((size_t)b * K + k) * 4 + (c >> 1)] = acc;
            }
        }
        __syncthreads();  // the planes and rows are read before the next sample
    }
    if constexpr (BWD && SLAB)
        for (size_t e = tid; e < 2 * PD; e += T)
            gslab[e] = slab[(e >> n << n) + us_phys((int)(e & (D - 1)))];
}

#define US_TILE_KERNEL(NAME, BWD, ROWS, SLAB)                                            \
    extern "C" __global__ void __launch_bounds__(GT_MAX_THREADS) NAME(                   \
        const float* __restrict__ xr, const float* __restrict__ xi,                      \
        const float* __restrict__ gr, const float* __restrict__ gi,                      \
        const float* __restrict__ mre, const float* __restrict__ mim,                    \
        const float* __restrict__ cosb, const float* __restrict__ sinb,                  \
        const float* __restrict__ u4, float* __restrict__ outr, float* __restrict__ outi, \
        float* __restrict__ gmre, float* __restrict__ gmim, float* __restrict__ partials, \
        int B, int n, int K, int P, int U, int n_seg, GtTable tab) {                     \
        unrolled_tile_body<BWD, ROWS, SLAB>(xr, xi, gr, gi, mre, mim, cosb, sinb, u4,    \
                                            outr, outi, gmre, gmim, partials, B, n, K, P, \
                                            U, n_seg, tab);                              \
    }
US_TILE_KERNEL(unrolled_fwd_tile_kernel, false, true, false)
US_TILE_KERNEL(unrolled_fwd_tile_kernel_ldg, false, false, false)
US_TILE_KERNEL(unrolled_bwd_tile_kernel, true, true, true)
US_TILE_KERNEL(unrolled_bwd_tile_kernel_ldg, true, false, true)
US_TILE_KERNEL(unrolled_bwd_tile_kernel_global, true, false, false)

// -- host entries --------------------------------------------------------------

extern "C" const char* qc_unrolled_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// The kernel of (route, direction, variant), opted in to `smem` bytes on the
// current device. route 0: warp (variant = RB), 1: tile (variant = ROWS |
// SLAB << 1 in the order above).
static size_t smem_done[2][2][UW_MAX_RB + 1][GT_MAX_DEVICES];

static const void* pick_kernel(int route, int bwd, int variant) {
    static const void* warp[2][UW_MAX_RB + 1] = {
        {(const void*)unrolled_fwd_warp_kernel_rb0, (const void*)unrolled_fwd_warp_kernel_rb1,
         (const void*)unrolled_fwd_warp_kernel_rb2, (const void*)unrolled_fwd_warp_kernel_rb3,
         (const void*)unrolled_fwd_warp_kernel_rb4},
        {(const void*)unrolled_bwd_warp_kernel_rb0, (const void*)unrolled_bwd_warp_kernel_rb1,
         (const void*)unrolled_bwd_warp_kernel_rb2, (const void*)unrolled_bwd_warp_kernel_rb3,
         (const void*)unrolled_bwd_warp_kernel_rb4}};
    if (route == 0) return variant >= 0 && variant <= UW_MAX_RB ? warp[bwd][variant] : nullptr;
    if (!bwd) return variant == 1   ? (const void*)unrolled_fwd_tile_kernel
                     : variant == 0 ? (const void*)unrolled_fwd_tile_kernel_ldg
                                    : nullptr;
    return variant == 3   ? (const void*)unrolled_bwd_tile_kernel
           : variant == 2 ? (const void*)unrolled_bwd_tile_kernel_ldg
           : variant == 0 ? (const void*)unrolled_bwd_tile_kernel_global
                          : nullptr;
}

// The kernel for n qubits on `route`, with `threads` threads, opted in to
// `smem` bytes; 0 or a CUDA error.
static int setup(int route, int bwd, int variant, int n, int threads, size_t smem,
                 const void** kern) {
    if (route == 0) {
        if (n < 1 || n > UW_MAX_QUBITS || threads < 32 || threads > UW_MAX_WARPS * 32 ||
            threads % 32)
            return (int)cudaErrorInvalidValue;
        variant = n > 5 ? n - 5 : 0;
    } else if (n < US_TILE_BITS + 5 || n > US_MAX_QUBITS ||
               threads != 1 << (n - US_TILE_BITS)) {
        return (int)cudaErrorInvalidValue;
    }
    *kern = pick_kernel(route, bwd, variant);
    if (!*kern) return (int)cudaErrorInvalidValue;
    return opt_in_smem(*kern, smem, smem_done[route][bwd][variant]);
}

// CTAs of `threads` threads with `smem` bytes each that one SM holds at once.
extern "C" int qc_unrolled_occupancy(int route, int bwd, int variant, int n, int threads,
                                     int smem, int* blocks) {
    const void* kern = nullptr;
    int err = setup(route, bwd, variant, n, threads, (size_t)smem, &kern);
    if (err) return err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, threads,
                                                              (size_t)smem);
}

// One launch of either route and direction. Forward: (x0, x1) the state in,
// (out0, out1) the state out; g0, g1, gmre, gmim, partials unused. Backward:
// (x0, x1) the final state, (g0, g1) its cotangent, (out0, out1) the input
// cotangent. n_seg: the tile route's segment count.
extern "C" int qc_unrolled_launch(int route, int bwd, int variant, const float* x0,
                                  const float* x1, const float* g0, const float* g1,
                                  const float* mre, const float* mim, const float* cosb,
                                  const float* sinb, const float* u4, float* out0,
                                  float* out1, float* gmre, float* gmim, float* partials,
                                  int B, int n, int K, int P, int U, int n_seg,
                                  const unsigned int* steps, int n_steps, int G,
                                  int threads, int smem, void* stream) {
    GtTable tab;
    int err = fill_table(&tab, steps, n_steps);
    if (err) return err;
    const void* kern = nullptr;
    err = setup(route, bwd, variant, n, threads, (size_t)smem, &kern);
    if (err) return err;
    const cudaStream_t s = (cudaStream_t)stream;
    if (route == 1) {
        void* args[] = {&x0, &x1, &g0, &g1, &mre, &mim, &cosb, &sinb, &u4, &out0, &out1,
                        &gmre, &gmim, &partials, &B, &n, &K, &P, &U, &n_seg, &tab};
        err = (int)cudaLaunchKernel(kern, G, threads, args, (size_t)smem, s);
    } else if (bwd) {
        void* args[] = {&x0, &x1, &g0, &g1, &mre, &mim, &cosb, &sinb, &u4, &out0, &out1,
                        &gmre, &gmim, &partials, &B, &n, &K, &P, &U, &tab};
        err = (int)cudaLaunchKernel(kern, G, threads, args, (size_t)smem, s);
    } else {
        void* args[] = {&x0, &x1, &mre, &mim, &cosb, &sinb, &u4, &out0, &out1,
                        &B, &n, &K, &P, &U, &tab};
        err = (int)cudaLaunchKernel(kern, G, threads, args, (size_t)smem, s);
    }
    return err ? err : (int)cudaGetLastError();
}

// K4b (slab_sum.cuh).
extern "C" int qc_unrolled_reduce(const float* partials, float* out, int slab,
                                  int G, void* stream) {
    return slab_sum_launch(partials, out, slab, G, stream);
}
