// Gate-table loop kernels for Hopper (sm_90a), plain FP32 FMA.
//
// Replaces qcpinn_tpu/ops/pallas_loop.py::_forward_kernel (K5) and
// ::_backward_kernel (K6). One generic step body walks a gate table; the
// state of one sample is a row of 2^n split re/im f32 amplitudes, wire 0
// the most significant bit. A step is one of
//   mat  : a shared 2x2 from the [K, 8] scalar bank (re/im of m00, m01, m10,
//          m11) on target bit ga, optionally only where control bit gb is 1;
//   diag : multiply by a phase plane (cos + i sin)[2^n] from the [P, 2^n]
//          banks;
//   u2q  : a fixed 4x4 from the [U, 32] bank on bits (ga, gb), index order
//          (bit_a, bit_b).
// The partner of amplitude i across bit g is i ^ (1 << g); the TPU kernel's
// lane/sublane rolls exist only for Mosaic's layout and are not carried.
//
// What bounds it: every step touches each amplitude once with a handful of
// flops (a mat step is 2 complex multiply-adds per amplitude), so the work
// is device-memory (or shared-memory) traffic, not FMA throughput. At
// n <= 12 one sample (<= 32 KB forward, 64 KB backward with the cotangent)
// stays in a CTA's shared memory for the whole table: one read and one
// write of device memory. At 13 <= n <= 16 a sample (512 KB at 16 qubits)
// exceeds a CTA's 227 KB, so one CTA works in place on its row in device
// memory and __syncthreads() orders the steps (it also orders global
// memory within the block): one pass over the row per step, mostly from
// L2. A CTA cluster holding the row in distributed shared memory is the
// known next step.
//
// The backward sweeps the table in reverse from the final state with O(1)
// extra state: it applies each gate's inverse (conj-transposed 2x2/4x4,
// conjugate phase) to recover the step's input, accumulates the matrix
// cotangent mbar[i][j] = sum g_i conj(x_j) over the gated pairs and the
// phase cotangents, and pulls the cotangent g back through the same
// inverse. The TPU kernel sums those over a sequential grid; CTAs run in
// parallel with no order, so a persistent grid of G CTAs each sums its
// samples into a private slab in device memory, and a second kernel adds
// the G slabs in a fixed order. Within a step the 8 matrix sums are a
// block reduction in a fixed order (warp shuffles, then shared memory). No
// float atomics: two runs are bit-equal.
//
// The table, the addressing and the reductions are shared with
// unrolled_sv.cu (gate_table.cuh). Plain C interface (loaded with ctypes);
// every entry returns cudaGetLastError() after its launch.

#include "gate_table.cuh"

#define QG_THREADS GT_MAX_THREADS
#define QG_SMEM_MAX_QUBITS 12

// One forward step on a row (shared or device memory); ends with a barrier.
__device__ __forceinline__ void fwd_step(float* sr, float* si, int D,
                                         GtStep st,
                                         const float* __restrict__ mats,
                                         const float* __restrict__ u4,
                                         const float* __restrict__ cosb,
                                         const float* __restrict__ sinb) {
    const int tid = threadIdx.x;
    if (st.kind == 0) {
        const float* m = mats + 8 * st.idx;
        const float m00r = m[0], m00i = m[1], m01r = m[2], m01i = m[3];
        const float m10r = m[4], m10i = m[5], m11r = m[6], m11i = m[7];
        const int bit = 1 << st.ga;
        for (int p = tid; p < (D >> 1); p += QG_THREADS) {
            const int i0 = insert0(p, st.ga), i1 = i0 | bit;
            if (st.ctrl && !((i0 >> st.gb) & 1)) continue;
            const float ar = sr[i0], ai = si[i0], br = sr[i1], bi = si[i1];
            float yr, yi;
            cmadd2(m00r, m00i, ar, ai, m01r, m01i, br, bi, yr, yi);
            sr[i0] = yr;
            si[i0] = yi;
            cmadd2(m10r, m10i, ar, ai, m11r, m11i, br, bi, yr, yi);
            sr[i1] = yr;
            si[i1] = yi;
        }
    } else if (st.kind == 1) {
        const float* pc = cosb + (size_t)st.idx * D;
        const float* ps = sinb + (size_t)st.idx * D;
        for (int i = tid; i < D; i += QG_THREADS) {
            const float c = pc[i], s = ps[i];
            const float a = sr[i], d = si[i];
            sr[i] = fmaf(a, c, -d * s);
            si[i] = fmaf(a, s, d * c);
        }
    } else {
        const float* u = u4 + 32 * st.idx;
        for (int q = tid; q < (D >> 2); q += QG_THREADS) {
            int idx[4];
            quad_index(q, st.ga, st.gb, idx);
            apply4<false>(sr, si, idx, u);
        }
    }
    __syncthreads();
}

extern "C" __global__ void __launch_bounds__(QG_THREADS)
gate_loop_fwd_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                     const float* __restrict__ mats, const float* __restrict__ u4,
                     const float* __restrict__ cosb,
                     const float* __restrict__ sinb, float* yr, float* yi,
                     int B, int n, int use_smem, GtTable tab) {
    extern __shared__ float smem[];
    const int D = 1 << n;
    const int tid = threadIdx.x;
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
        const size_t base = (size_t)b * D;
        // shared memory at n <= 12, else in place on the output row
        float* sr = use_smem ? smem : yr + base;
        float* si = use_smem ? smem + D : yi + base;
        for (int e = tid; e < D; e += QG_THREADS) {
            sr[e] = xr[base + e];
            si[e] = xi[base + e];
        }
        __syncthreads();
        for (int k = 0; k < tab.n_steps; ++k)
            fwd_step(sr, si, D, decode(tab.step[k]), mats, u4, cosb, sinb);
        if (use_smem) {
            for (int e = tid; e < D; e += QG_THREADS) {
                yr[base + e] = sr[e];
                yi[base + e] = si[e];
            }
            __syncthreads();
        }
    }
}

extern "C" __global__ void __launch_bounds__(QG_THREADS)
gate_loop_bwd_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
                     const float* __restrict__ gr, const float* __restrict__ gi,
                     const float* __restrict__ mats, const float* __restrict__ u4,
                     const float* __restrict__ cosb,
                     const float* __restrict__ sinb, float* gxr, float* gxi,
                     float* scratch, float* __restrict__ partials, int slab,
                     int mats_len, int phase_len, int B, int n, int use_smem,
                     GtTable tab) {
    extern __shared__ float smem[];
    __shared__ float red[GT_MAX_WARPS * 8];
    const int D = 1 << n;
    const int tid = threadIdx.x;
    float* part = partials + (size_t)blockIdx.x * slab;
    float* gcos = part + mats_len;
    float* gsin = gcos + phase_len;
    for (int e = tid; e < slab; e += QG_THREADS) part[e] = 0.f;
    __syncthreads();
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
        const size_t base = (size_t)b * D;
        // state s in shared memory or this CTA's scratch row; cotangent q
        // in shared memory or in place on the output row
        float* sr = use_smem ? smem : scratch + (size_t)blockIdx.x * 2 * D;
        float* si = sr + D;
        float* qr = use_smem ? smem + 2 * D : gxr + base;
        float* qi = use_smem ? smem + 3 * D : gxi + base;
        for (int e = tid; e < D; e += QG_THREADS) {
            sr[e] = yr[base + e];
            si[e] = yi[base + e];
            qr[e] = gr[base + e];
            qi[e] = gi[base + e];
        }
        __syncthreads();
        for (int k = tab.n_steps - 1; k >= 0; --k) {
            const GtStep st = decode(tab.step[k]);
            if (st.kind == 0) {
                // the inverse is conj(M)^T: x0 = m00* y0 + m10* y1,
                // x1 = m01* y0 + m11* y1 (and the same for g)
                const float* m = mats + 8 * st.idx;
                const float a00r = m[0], a00i = -m[1], a01r = m[4], a01i = -m[5];
                const float a10r = m[2], a10i = -m[3], a11r = m[6], a11i = -m[7];
                const int bit = 1 << st.ga;
                float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
                for (int p = tid; p < (D >> 1); p += QG_THREADS) {
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
                    float* gm = part + 8 * st.idx;
#pragma unroll
                    for (int e = 0; e < 8; ++e) gm[e] += acc[e];
                }
            } else if (st.kind == 1) {
                const float* pc = cosb + (size_t)st.idx * D;
                const float* ps = sinb + (size_t)st.idx * D;
                float* gc = gcos + (size_t)st.idx * D;
                float* gs = gsin + (size_t)st.idx * D;
                for (int i = tid; i < D; i += QG_THREADS) {
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
                for (int q = tid; q < (D >> 2); q += QG_THREADS) {
                    int idx[4];
                    quad_index(q, st.ga, st.gb, idx);
                    apply4<true>(sr, si, idx, u);
                    apply4<true>(qr, qi, idx, u);
                }
            }
            __syncthreads();
        }
        if (use_smem) {
            for (int e = tid; e < D; e += QG_THREADS) {
                gxr[base + e] = qr[e];
                gxi[base + e] = qi[e];
            }
        }
        __syncthreads();
    }
}

// out[e] = sum_{c < G} partials[c][e], in a fixed order.
extern "C" __global__ void gate_loop_reduce_kernel(
    const float* __restrict__ partials, float* __restrict__ out, int slab,
    int G) {
    slab_sum(partials, out, slab, G);
}

static size_t fwd_smem_done[GT_MAX_DEVICES];
static size_t bwd_smem_done[GT_MAX_DEVICES];

extern "C" const char* qc_gate_loop_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

extern "C" int qc_gate_loop_fwd(const float* xr, const float* xi,
                                const float* mats, const float* u4,
                                const float* cosb, const float* sinb, float* yr,
                                float* yi, int B, int n,
                                const unsigned int* steps, int n_steps,
                                void* stream) {
    GtTable tab;
    int err = fill_table(&tab, steps, n_steps);
    if (err) return err;
    const int use_smem = n <= QG_SMEM_MAX_QUBITS;
    const size_t smem = use_smem ? sizeof(float) * 2 * ((size_t)1 << n) : 0;
    err = opt_in_smem((const void*)gate_loop_fwd_kernel, smem, fwd_smem_done);
    if (err) return err;
    gate_loop_fwd_kernel<<<B, QG_THREADS, smem, (cudaStream_t)stream>>>(
        xr, xi, mats, u4, cosb, sinb, yr, yi, B, n, use_smem, tab);
    return (int)cudaGetLastError();
}

extern "C" int qc_gate_loop_bwd(const float* yr, const float* yi,
                                const float* gr, const float* gi,
                                const float* mats, const float* u4,
                                const float* cosb, const float* sinb, float* gxr,
                                float* gxi, float* scratch, float* partials,
                                int slab, int mats_len, int phase_len, int B,
                                int n, const unsigned int* steps, int n_steps,
                                int G, void* stream) {
    GtTable tab;
    int err = fill_table(&tab, steps, n_steps);
    if (err) return err;
    const int use_smem = n <= QG_SMEM_MAX_QUBITS;
    const size_t smem = use_smem ? sizeof(float) * 4 * ((size_t)1 << n) : 0;
    err = opt_in_smem((const void*)gate_loop_bwd_kernel, smem, bwd_smem_done);
    if (err) return err;
    gate_loop_bwd_kernel<<<G, QG_THREADS, smem, (cudaStream_t)stream>>>(
        yr, yi, gr, gi, mats, u4, cosb, sinb, gxr, gxi, scratch, partials, slab,
        mats_len, phase_len, B, n, use_smem, tab);
    return (int)cudaGetLastError();
}

extern "C" int qc_gate_loop_reduce(const float* partials, float* out, int slab,
                                   int G, void* stream) {
    const int threads = 256;
    const int blocks = (slab + threads - 1) / threads;
    gate_loop_reduce_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        partials, out, slab, G);
    return (int)cudaGetLastError();
}
