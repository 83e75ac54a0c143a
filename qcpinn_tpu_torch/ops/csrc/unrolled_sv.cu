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
// (a fixed-order block reduction: warp shuffles, then shared memory) and
// pulls the cotangent g back through the same inverse. The phase
// cotangents are batch sums: a persistent grid of G CTAs sums its samples
// into one private slab each in device memory, and the slab sum
// (slab_sum.cuh) adds the G slabs in a fixed order. No float atomics: two
// runs are bit-equal.
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

// K4b (slab_sum.cuh).
extern "C" int qc_unrolled_reduce(const float* partials, float* out, int slab,
                                  int G, void* stream) {
    return slab_sum_launch(partials, out, slab, G, stream);
}
