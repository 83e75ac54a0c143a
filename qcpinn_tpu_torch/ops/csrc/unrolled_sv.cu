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
// What bounds it: every step touches each amplitude once with a handful of
// flops (a mat step is 2 complex multiply-adds per amplitude), so the work
// is memory traffic, not FMA throughput. At n <= 12 one sample (<= 32 KB
// forward, 64 KB backward with the cotangent) stays in one CTA's shared
// memory for the whole program: device memory sees the state read once and
// written once, and each step is one pass over shared memory, one thread
// per amplitude pair, ending in a barrier.
//
// The backward sweeps the program in reverse from the final state with
// O(1) extra state: it applies each gate's inverse (conj-transposed 2x2 or
// 4x4, conjugate phase) to recover the step's input, writes the sample's
// matrix cotangent mbar[i][j] = sum g_i conj(x_j) over the gated pairs
// and pulls the cotangent g back through the same inverse. The phase
// cotangents are batch sums: a persistent grid of G CTAs sums its samples
// into one private slab each, and the slab sum (slab_sum.cuh) adds the G
// slabs in a fixed order. No float atomics: two runs are bit-equal. Two
// backward kernels, picked by n in sv_kernel.py: unrolled_bwd_kernel (the
// CTA route, 10 <= n <= 12) holds a sample in a CTA's shared memory (a
// fixed-order block reduction per mat step, the slab in device memory);
// unrolled_bwd_warp_kernel_rb* (the warp route, 1 <= n <= 9) holds it in
// one warp's registers (see its section below).
//
// The table, the addressing and the block reduction are shared with
// gate_loop.cu (gate_table.cuh), the slab sum with every backward. Plain C
// interface (loaded with ctypes); every entry returns cudaGetLastError()
// after its launch.

#include "gate_table.cuh"
#include "slab_sum.cuh"

#define US_MAX_QUBITS 12

extern "C" __global__ void __launch_bounds__(GT_MAX_THREADS)
unrolled_fwd_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                    const float* __restrict__ mre, const float* __restrict__ mim,
                    const float* __restrict__ cosb,
                    const float* __restrict__ sinb,
                    const float* __restrict__ u4, float* __restrict__ yr,
                    float* __restrict__ yi, int B, int n, int K, GtTable tab) {
    extern __shared__ float smem[];
    const int D = 1 << n;
    const int tid = threadIdx.x, nt = blockDim.x;
    float* sr = smem;
    float* si = smem + D;
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
        const size_t base = (size_t)b * D;
        for (int e = tid; e < D; e += nt) {
            sr[e] = xr[base + e];
            si[e] = xi[base + e];
        }
        __syncthreads();
        for (int k = 0; k < tab.n_steps; ++k) {
            const GtStep st = decode(tab.step[k]);
            if (st.kind == 0) {
                const size_t m = ((size_t)b * K + st.idx) * 4;
                const float m00r = mre[m], m00i = mim[m];
                const float m01r = mre[m + 1], m01i = mim[m + 1];
                const float m10r = mre[m + 2], m10i = mim[m + 2];
                const float m11r = mre[m + 3], m11i = mim[m + 3];
                const int bit = 1 << st.ga;
                for (int p = tid; p < (D >> 1); p += nt) {
                    const int i0 = insert0(p, st.ga), i1 = i0 | bit;
                    if (st.ctrl && !((i0 >> st.gb) & 1)) continue;
                    const float ar = sr[i0], ai = si[i0], br = sr[i1], bi = si[i1];
                    float vr, vi;
                    cmadd2(m00r, m00i, ar, ai, m01r, m01i, br, bi, vr, vi);
                    sr[i0] = vr;
                    si[i0] = vi;
                    cmadd2(m10r, m10i, ar, ai, m11r, m11i, br, bi, vr, vi);
                    sr[i1] = vr;
                    si[i1] = vi;
                }
            } else if (st.kind == 1) {
                const float* pc = cosb + (size_t)st.idx * D;
                const float* ps = sinb + (size_t)st.idx * D;
                for (int i = tid; i < D; i += nt) {
                    const float c = pc[i], s = ps[i];
                    const float a = sr[i], d = si[i];
                    sr[i] = fmaf(a, c, -d * s);
                    si[i] = fmaf(a, s, d * c);
                }
            } else {
                const float* u = u4 + 32 * st.idx;
                for (int q = tid; q < (D >> 2); q += nt) {
                    int idx[4];
                    quad_index(q, st.ga, st.gb, idx);
                    apply4<false>(sr, si, idx, u);
                }
            }
            __syncthreads();
        }
        for (int e = tid; e < D; e += nt) {
            yr[base + e] = sr[e];
            yi[base + e] = si[e];
        }
        __syncthreads();
    }
}

extern "C" __global__ void __launch_bounds__(GT_MAX_THREADS)
unrolled_bwd_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
                    const float* __restrict__ gr, const float* __restrict__ gi,
                    const float* __restrict__ mre, const float* __restrict__ mim,
                    const float* __restrict__ cosb,
                    const float* __restrict__ sinb,
                    const float* __restrict__ u4, float* __restrict__ gxr,
                    float* __restrict__ gxi, float* __restrict__ gmre,
                    float* __restrict__ gmim, float* __restrict__ partials,
                    int B, int n, int K, int P, GtTable tab) {
    extern __shared__ float smem[];
    __shared__ float red[GT_MAX_WARPS * 8];
    const int D = 1 << n;
    const int tid = threadIdx.x, nt = blockDim.x;
    float* gcos = partials + (size_t)blockIdx.x * 2 * P * D;
    float* gsin = gcos + (size_t)P * D;
    for (int e = tid; e < 2 * P * D; e += nt) gcos[e] = 0.f;
    float* sr = smem;
    float* si = smem + D;
    float* qr = smem + 2 * D;
    float* qi = smem + 3 * D;
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
        const size_t base = (size_t)b * D;
        for (int e = tid; e < D; e += nt) {
            sr[e] = yr[base + e];
            si[e] = yi[base + e];
            qr[e] = gr[base + e];
            qi[e] = gi[base + e];
        }
        // the sample's matrix cotangents: zero, then one += per mat step
        // by thread 0 (the barrier below orders the two)
        for (int e = tid; e < 4 * K; e += nt) {
            gmre[(size_t)b * 4 * K + e] = 0.f;
            gmim[(size_t)b * 4 * K + e] = 0.f;
        }
        __syncthreads();
        for (int k = tab.n_steps - 1; k >= 0; --k) {
            const GtStep st = decode(tab.step[k]);
            if (st.kind == 0) {
                // the inverse is conj(M)^T: x0 = m00* y0 + m10* y1,
                // x1 = m01* y0 + m11* y1 (and the same for g)
                const size_t m = ((size_t)b * K + st.idx) * 4;
                const float a00r = mre[m], a00i = -mim[m];
                const float a01r = mre[m + 2], a01i = -mim[m + 2];
                const float a10r = mre[m + 1], a10i = -mim[m + 1];
                const float a11r = mre[m + 3], a11i = -mim[m + 3];
                const int bit = 1 << st.ga;
                float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
                for (int p = tid; p < (D >> 1); p += nt) {
                    const int i0 = insert0(p, st.ga), i1 = i0 | bit;
                    if (st.ctrl && !((i0 >> st.gb) & 1)) continue;
                    float x0r, x0i, x1r, x1i;
                    cmadd2(a00r, a00i, sr[i0], si[i0], a01r, a01i, sr[i1], si[i1],
                           x0r, x0i);
                    cmadd2(a10r, a10i, sr[i0], si[i0], a11r, a11i, sr[i1], si[i1],
                           x1r, x1i);
                    sr[i0] = x0r;
                    si[i0] = x0i;
                    sr[i1] = x1r;
                    si[i1] = x1i;
                    const float g0r = qr[i0], g0i = qi[i0];
                    const float g1r = qr[i1], g1i = qi[i1];
                    // mbar[i][j] += g_i conj(x_j)
                    acc[0] += g0r * x0r + g0i * x0i;
                    acc[1] += g0i * x0r - g0r * x0i;
                    acc[2] += g0r * x1r + g0i * x1i;
                    acc[3] += g0i * x1r - g0r * x1i;
                    acc[4] += g1r * x0r + g1i * x0i;
                    acc[5] += g1i * x0r - g1r * x0i;
                    acc[6] += g1r * x1r + g1i * x1i;
                    acc[7] += g1i * x1r - g1r * x1i;
                    float hr, hi;
                    cmadd2(a00r, a00i, g0r, g0i, a01r, a01i, g1r, g1i, hr, hi);
                    qr[i0] = hr;
                    qi[i0] = hi;
                    cmadd2(a10r, a10i, g0r, g0i, a11r, a11i, g1r, g1i, hr, hi);
                    qr[i1] = hr;
                    qi[i1] = hi;
                }
                block_sum8(acc, red);
                if (tid == 0) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        gmre[m + e] += acc[2 * e];
                        gmim[m + e] += acc[2 * e + 1];
                    }
                }
            } else if (st.kind == 1) {
                const float* pc = cosb + (size_t)st.idx * D;
                const float* ps = sinb + (size_t)st.idx * D;
                float* gc = gcos + (size_t)st.idx * D;
                float* gs = gsin + (size_t)st.idx * D;
                for (int i = tid; i < D; i += nt) {
                    const float c = pc[i], s = ps[i];
                    // input recovery: conjugate phase
                    const float a = fmaf(c, sr[i], s * si[i]);
                    const float d = fmaf(c, si[i], -s * sr[i]);
                    sr[i] = a;
                    si[i] = d;
                    const float u = qr[i], v = qi[i];
                    // phase cotangents (out = (c + i s) * in)
                    gc[i] += u * a + v * d;
                    gs[i] += -u * d + v * a;
                    qr[i] = fmaf(c, u, s * v);
                    qi[i] = fmaf(c, v, -s * u);
                }
            } else {
                const float* u = u4 + 32 * st.idx;
                for (int q = tid; q < (D >> 2); q += nt) {
                    int idx[4];
                    quad_index(q, st.ga, st.gb, idx);
                    apply4<true>(sr, si, idx, u);
                    apply4<true>(qr, qi, idx, u);
                }
            }
            __syncthreads();
        }
        for (int e = tid; e < D; e += nt) {
            gxr[base + e] = qr[e];
            gxi[base + e] = qi[e];
        }
        __syncthreads();
    }
}

// -- K4 for 1 <= n <= 9: the warp-resident reverse sweep ---------------------
//
// The CTA kernel above gives a 128-thread CTA to a sample of 256 amplitudes
// at 8 qubits: each thread works one pair, about 50 flops a step, and every
// step ends in __syncthreads() (a mat step also in a block reduction with
// its own barriers, and thread 0's read-modify-write of 8 floats in device
// memory; a diag step in a read-modify-write of the CTA's phase slab in
// device memory). That layout suits 4,096 amplitudes, not 256. Here one
// warp holds a sample in registers for the whole sweep: the 2^n amplitudes
// of the state and of the cotangent, re and im, are R = 2^RB registers a
// lane each (RB = max(n - 5, 0): 8 at 8 qubits), amplitude i in lane
// i >> RB, register i & (R - 1). The low RB bits index the registers, the
// high bits the lane. A gate on a register bit is local to a lane; on a
// lane bit it takes one __shfl_xor_sync per value (the partner lane's
// amplitude); a u2q gathers its quad from up to four lanes. At n < 5 the
// lanes beyond 2^n hold zeros and sit idle. The sweep has no barrier:
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
// the slab sum (K4b) adds the slabs. No float atomics: two runs are
// bit-equal. A persistent grid: warp w of CTA c sweeps samples
// c * W + w, + G * W, ...
//
// What bounds it: per step a lane does R/2 (register bit) or R (lane bit,
// with 4 shuffles each) pair updates of about 50 flops, so the work is
// instruction throughput (FMA and shuffle) over the batch, and at a small
// batch (one sample a warp) the sweep's latency. So nothing in a step
// waits on device memory (each sample's matrices come into shared memory
// with its state, the phase rows and the 4x4s once a CTA, before the
// sweep), and nothing in a step branches per amplitude: a control bit
// selects, it does not skip, so a step is straight-line code the compiler
// schedules across amplitudes.

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

// The inverse of a mat step, conj(M)^T: a[i][j] = conj(m[j][i]), complex.
struct UwMat {
    float r[2][2], i[2][2];
};

// A mat step on register bit G: each lane recovers, accumulates and pulls
// back its own pairs (r, r | 2^G); with CTRL, where the control bit gb is
// 0 the pair keeps its values and adds nothing.
template <int RB, int G, bool CTRL>
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
        float x0r, x0i, x1r, x1i, h0r, h0i, h1r, h1i;
        cmadd2(a.r[0][0], a.i[0][0], sr[r], si[r], a.r[0][1], a.i[0][1], sr[r1], si[r1],
               x0r, x0i);
        cmadd2(a.r[1][0], a.i[1][0], sr[r], si[r], a.r[1][1], a.i[1][1], sr[r1], si[r1],
               x1r, x1i);
        const float g0r = qr[r], g0i = qi[r], g1r = qr[r1], g1i = qi[r1];
        cmadd2(a.r[0][0], a.i[0][0], g0r, g0i, a.r[0][1], a.i[0][1], g1r, g1i, h0r, h0i);
        cmadd2(a.r[1][0], a.i[1][0], g0r, g0i, a.r[1][1], a.i[1][1], g1r, g1i, h1r, h1i);
        acc[0] += on ? g0r * x0r + g0i * x0i : 0.f;
        acc[1] += on ? g0i * x0r - g0r * x0i : 0.f;
        acc[2] += on ? g0r * x1r + g0i * x1i : 0.f;
        acc[3] += on ? g0i * x1r - g0r * x1i : 0.f;
        acc[4] += on ? g1r * x0r + g1i * x0i : 0.f;
        acc[5] += on ? g1i * x0r - g1r * x0i : 0.f;
        acc[6] += on ? g1r * x1r + g1i * x1i : 0.f;
        acc[7] += on ? g1i * x1r - g1r * x1i : 0.f;
        sr[r] = on ? x0r : sr[r];
        si[r] = on ? x0i : si[r];
        sr[r1] = on ? x1r : sr[r1];
        si[r1] = on ? x1i : si[r1];
        qr[r] = on ? h0r : g0r;
        qi[r] = on ? h0i : g0i;
        qr[r1] = on ? h1r : g1r;
        qi[r1] = on ? h1i : g1i;
    }
}

// A mat step on lane bit L: the pair of register r is (this lane, lane ^ 2^L).
// Each lane takes the partner's state and cotangent by shuffle, computes its
// own recovered amplitude and the partner's (cheaper in registers than a
// second shuffle), and accumulates row h of mbar, h its own value of the
// bit.
template <int RB, bool CTRL>
__device__ __forceinline__ void uw_mat_lane(float (&sr)[1 << RB], float (&si)[1 << RB],
                                            float (&qr)[1 << RB], float (&qi)[1 << RB],
                                            const UwMat& a, int L, int gb, int lane,
                                            float (&acc)[8]) {
    constexpr int R = 1 << RB;
    const int h = (lane >> L) & 1, m = 1 << L;
    // x_h = a[h][h] y_own + a[h][o] y_oth;  x_o = a[o][h] y_own + a[o][o] y_oth
    const float csr = h ? a.r[1][1] : a.r[0][0], csi = h ? a.i[1][1] : a.i[0][0];
    const float cor = h ? a.r[1][0] : a.r[0][1], coi = h ? a.i[1][0] : a.i[0][1];
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
}

// The step's target bit picks the code (a register bit G, or a lane bit),
// its control bit whether the pairs select.
template <int RB, bool CTRL, int G = 0>
__device__ __forceinline__ void uw_mat(float (&sr)[1 << RB], float (&si)[1 << RB],
                                       float (&qr)[1 << RB], float (&qi)[1 << RB],
                                       const UwMat& a, int ga, int gb, int lane,
                                       float (&acc)[8]) {
    if constexpr (G == RB) {
        uw_mat_lane<RB, CTRL>(sr, si, qr, qi, a, ga - RB, gb, lane, acc);
    } else {
        if (ga == G)
            uw_mat_reg<RB, G, CTRL>(sr, si, qr, qi, a, gb, lane, acc);
        else
            uw_mat<RB, CTRL, G + 1>(sr, si, qr, qi, a, ga, gb, lane, acc);
    }
}

// One quad (base register r) of a u2q step on one plane pair: gather the
// four entries (by shuffle where a bit is a lane bit), apply the inverse
// rows w, keep the entries this lane holds.
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

// The inverse of a fixed 4x4 (conj(U)^T) on bits (a, b), entries in (bit a,
// bit b) order, on the state and the cotangent. GA, GB: the register bit of
// a and of b, or -1 for a lane bit (la, lb). u: the 4x4's [32] row in
// shared memory.
template <int RB, int GA, int GB>
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
            wr[e][c] = u[(c * 4 + e) * 2];
            wi[e][c] = -u[(c * 4 + e) * 2 + 1];
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
        uw_quad<RB, GA, GB>(qr, qi, r, wr, wi, src, own);
    }
}

template <int RB, int GA, int GB = 0>
__device__ __forceinline__ void uw_u2q_b(float (&sr)[1 << RB], float (&si)[1 << RB],
                                         float (&qr)[1 << RB], float (&qi)[1 << RB],
                                         const float* u, int ga, int gb, int lane) {
    if constexpr (GB == RB) {
        uw_u2q_apply<RB, GA, -1>(sr, si, qr, qi, u, ga - RB, gb - RB, lane);
    } else {
        if (gb == GB)
            uw_u2q_apply<RB, GA, GB>(sr, si, qr, qi, u, ga - RB, gb - RB, lane);
        else
            uw_u2q_b<RB, GA, GB + 1>(sr, si, qr, qi, u, ga, gb, lane);
    }
}

template <int RB, int GA = 0>
__device__ __forceinline__ void uw_u2q(float (&sr)[1 << RB], float (&si)[1 << RB],
                                       float (&qr)[1 << RB], float (&qi)[1 << RB],
                                       const float* u, int ga, int gb, int lane) {
    if constexpr (GA == RB) {
        uw_u2q_b<RB, -1>(sr, si, qr, qi, u, ga, gb, lane);
    } else {
        if (ga == GA)
            uw_u2q_b<RB, GA>(sr, si, qr, qi, u, ga, gb, lane);
        else
            uw_u2q<RB, GA + 1>(sr, si, qr, qi, u, ga, gb, lane);
    }
}

// Shared memory a CTA of W warps: per warp 8K floats of matrix cotangents
// and 8K of the sample's matrices, then per warp 2 P D of phase cotangents,
// then the CTA's copy of the phase rows (2 P D) and of the 4x4s (32 U);
// qc_unrolled_bwd_warp and sv_kernel.warp_config compute the same.
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
    for (size_t e = threadIdx.x; e < (size_t)P * D; e += blockDim.x) {
        pcos[e] = cosb[e];
        psin[e] = sinb[e];
    }
    for (int e = threadIdx.x; e < 32 * U; e += blockDim.x) pu4[e] = u4[e];
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
                const float* m = mt + st.idx * 4;
                UwMat a;
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        a.r[i][j] = m[2 * j + i];
                        a.i[i][j] = -m[4 * K + 2 * j + i];
                    }
                float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
                if (st.ctrl)
                    uw_mat<RB, true>(sr, si, qr, qi, a, st.ga, st.gb, lane, acc);
                else
                    uw_mat<RB, false>(sr, si, qr, qi, a, st.ga, st.gb, lane, acc);
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
                uw_u2q<RB>(sr, si, qr, qi, pu4 + 32 * st.idx, st.ga, st.gb, lane);
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
    }
UW_KERNEL(0)
UW_KERNEL(1)
UW_KERNEL(2)
UW_KERNEL(3)
UW_KERNEL(4)

static int check_shape(int n, int threads) {
    if (n < 1 || n > US_MAX_QUBITS) return (int)cudaErrorInvalidValue;
    if (threads < 32 || threads > GT_MAX_THREADS || threads % 32)
        return (int)cudaErrorInvalidValue;
    return 0;
}

static size_t fwd_smem_done[GT_MAX_DEVICES];
static size_t bwd_smem_done[GT_MAX_DEVICES];

extern "C" const char* qc_unrolled_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

extern "C" int qc_unrolled_fwd(const float* xr, const float* xi,
                               const float* mre, const float* mim,
                               const float* cosb, const float* sinb,
                               const float* u4, float* yr, float* yi, int B,
                               int n, int K, int threads,
                               const unsigned int* steps, int n_steps,
                               void* stream) {
    GtTable tab;
    int err = fill_table(&tab, steps, n_steps);
    if (!err) err = check_shape(n, threads);
    if (err) return err;
    const size_t smem = sizeof(float) * 2 * ((size_t)1 << n);
    err = opt_in_smem((const void*)unrolled_fwd_kernel, smem, fwd_smem_done);
    if (err) return err;
    unrolled_fwd_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        xr, xi, mre, mim, cosb, sinb, u4, yr, yi, B, n, K, tab);
    return (int)cudaGetLastError();
}

extern "C" int qc_unrolled_bwd(const float* yr, const float* yi,
                               const float* gr, const float* gi,
                               const float* mre, const float* mim,
                               const float* cosb, const float* sinb,
                               const float* u4, float* gxr, float* gxi,
                               float* gmre, float* gmim, float* partials, int B,
                               int n, int K, int P, int threads,
                               const unsigned int* steps, int n_steps, int G,
                               void* stream) {
    GtTable tab;
    int err = fill_table(&tab, steps, n_steps);
    if (!err) err = check_shape(n, threads);
    if (err) return err;
    const size_t smem = sizeof(float) * 4 * ((size_t)1 << n);
    err = opt_in_smem((const void*)unrolled_bwd_kernel, smem, bwd_smem_done);
    if (err) return err;
    unrolled_bwd_kernel<<<G, threads, smem, (cudaStream_t)stream>>>(
        yr, yi, gr, gi, mre, mim, cosb, sinb, u4, gxr, gxi, gmre, gmim, partials,
        B, n, K, P, tab);
    return (int)cudaGetLastError();
}

static size_t warp_smem_done[UW_MAX_RB + 1][GT_MAX_DEVICES];

static const void* warp_kernel(int rb) {
    switch (rb) {
        case 0: return (const void*)unrolled_bwd_warp_kernel_rb0;
        case 1: return (const void*)unrolled_bwd_warp_kernel_rb1;
        case 2: return (const void*)unrolled_bwd_warp_kernel_rb2;
        case 3: return (const void*)unrolled_bwd_warp_kernel_rb3;
        default: return (const void*)unrolled_bwd_warp_kernel_rb4;
    }
}

// The warp route's kernel for n qubits, opted in to `smem` bytes; 0 or a
// CUDA error.
static int warp_setup(int n, int warps, size_t smem, const void** kern) {
    if (n < 1 || n > UW_MAX_QUBITS || warps < 1 || warps > UW_MAX_WARPS)
        return (int)cudaErrorInvalidValue;
    const int rb = n > 5 ? n - 5 : 0;
    *kern = warp_kernel(rb);
    return opt_in_smem(*kern, smem, warp_smem_done[rb]);
}

// CTAs of `warps` warps with `smem` bytes each that one SM holds at once.
extern "C" int qc_unrolled_bwd_warp_occupancy(int n, int warps, int smem,
                                              int* blocks) {
    const void* kern = nullptr;
    int err = warp_setup(n, warps, (size_t)smem, &kern);
    if (err) return err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, warps * 32,
                                                              (size_t)smem);
}

extern "C" int qc_unrolled_bwd_warp(const float* yr, const float* yi,
                                    const float* gr, const float* gi,
                                    const float* mre, const float* mim,
                                    const float* cosb, const float* sinb,
                                    const float* u4, float* gxr, float* gxi,
                                    float* gmre, float* gmim, float* partials,
                                    int B, int n, int K, int P, int U, int warps,
                                    const unsigned int* steps, int n_steps, int G,
                                    void* stream) {
    GtTable tab;
    int err = fill_table(&tab, steps, n_steps);
    if (err) return err;
    const size_t PD = (size_t)P * ((size_t)1 << n);
    const size_t smem =
        sizeof(float) * ((size_t)warps * (16 * (size_t)K + 2 * PD) + 2 * PD + 32 * (size_t)U);
    const void* kern = nullptr;
    err = warp_setup(n, warps, smem, &kern);
    if (err) return err;
    const cudaStream_t s = (cudaStream_t)stream;
#define UW_LAUNCH(RB)                                                                 \
    unrolled_bwd_warp_kernel_rb##RB<<<G, warps * 32, smem, s>>>(                      \
        yr, yi, gr, gi, mre, mim, cosb, sinb, u4, gxr, gxi, gmre, gmim, partials, B, n, \
        K, P, U, tab)
    switch (n > 5 ? n - 5 : 0) {
        case 0: UW_LAUNCH(0); break;
        case 1: UW_LAUNCH(1); break;
        case 2: UW_LAUNCH(2); break;
        case 3: UW_LAUNCH(3); break;
        default: UW_LAUNCH(4); break;
    }
#undef UW_LAUNCH
    return (int)cudaGetLastError();
}

// K4b (slab_sum.cuh).
extern "C" int qc_unrolled_reduce(const float* partials, float* out, int slab,
                                  int G, void* stream) {
    return slab_sum_launch(partials, out, slab, G, stream);
}
