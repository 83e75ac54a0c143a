// Gate-table loop kernels for Hopper (sm_90a), plain FP32 FMA.
//
// Replaces qcpinn_tpu/ops/pallas_loop.py::_forward_kernel (K5) and
// ::_backward_kernel (K6). One generic step body walks a gate table; the
// state of one sample is a row of 2^n split re/im f32 amplitudes, wire 0 the
// most significant bit. A step is one of
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
// flops (a mat step is 2 complex multiply-adds per amplitude), so a design
// that passes over device memory once per step is bound by that traffic
// (37 passes over a 512 KB row per sample at 16 qubits). Here one sample
// stays on chip for the whole table: device memory sees it read once and
// written once, and every step is a pass over shared memory. Those passes,
// and the instructions around them, bound it now: one backward CTA of 16
// warps fills an SM's shared memory, which leaves little to hide latency.
//
// The sample is split over a thread-block cluster (gate_table.cuh): with
// L = min(n, 13) local bits, C = 2^(n - L) CTAs (1 up to 13 qubits, 2, 4, 8
// at 14, 15, 16), rank r holding amplitudes [r 2^L, (r + 1) 2^L) in its
// shared memory as one vector per amplitude: (re, im) of the state forward
// (64 KB at L = 13), of the state and the cotangent backward (128 KB), so a
// pair is two vector loads and two stores. L comes from
// loop_kernel.cluster_plan. A step on bits below L runs on the CTA's own
// slice and ends in __syncthreads(). A step on a bit >= L (a mat's target, a
// u2q's bits) pairs ranks: each rank of the step's group takes an equal
// share of its pairs or quads and reads and writes the peers' entries
// through distributed shared memory. Such a step is fenced by cluster
// barriers before and after; each sample, and the kernel, end with one, so
// no CTA refills or leaves its shared memory while a peer can still read it.
// Both kernels are persistent: G clusters (as many as fit on the card,
// cudaOccupancyMaxActiveClusters, at most B) walk the batch.
//
// The backward sweeps the table in reverse from the final state with O(1)
// extra state: it applies each gate's inverse (conj-transposed 2x2/4x4,
// conjugate phase) to recover the step's input, accumulates the matrix
// cotangent mbar[i][j] = sum g_i conj(x_j) over the gated pairs and the
// phase cotangents, and pulls the cotangent g back through the same
// inverse. The TPU kernel sums those over a sequential grid; clusters run
// in parallel with no order, so each cluster sums its samples into a
// private slab in device memory and a second kernel adds the G slabs in a
// fixed order. Within a CTA the 8 matrix sums of a step are a block
// reduction in a fixed order (a warp butterfly, then the warps in order)
// added into the CTA's own [K, 8] sums in shared memory; at the end
// rank 0 adds the ranks' sums in rank order into the slab. Each rank adds
// its phase cotangents into its own columns of the slab. No float atomics:
// two runs are bit-equal.
//
// The table, the addressing, the partition and the reductions are shared
// with unrolled_sv.cu (gate_table.cuh). Plain C interface (loaded with
// ctypes); every entry returns the launch's error.

#include "gate_table.cuh"
#include "slab_sum.cuh"

namespace cg = cooperative_groups;

#define QG_THREADS GT_MAX_THREADS
// two forward CTAs (64 KB each at L = 13) share an SM: at most 64
// registers a thread
#define QG_FWD_MIN_BLOCKS 2
// amplitudes a thread loads before it updates any in a backward diag step
#define QG_DIAG_ILP 4

// The barrier after a step: the whole cluster where the step or the next
// one crosses ranks (or at the end of a sample), else this CTA.
__device__ __forceinline__ void step_barrier(bool cluster_wide) {
    if (cluster_wide)
        cg::this_cluster().sync();
    else
        __syncthreads();
}

// A mat's control predicate where the control bit is >= L: the rank's bit.
__device__ __forceinline__ bool rank_idle(GtStep st, int L, unsigned rank) {
    return st.kind == 0 && st.ctrl && st.gb >= L && !((rank >> (st.gb - L)) & 1);
}

// A slice holds one vector per amplitude: (re, im) of the state forward
// (float2), (re, im) of the state and of the cotangent backward (float4).
// So a pair or a quad is 2 or 4 vector accesses, local or through
// distributed shared memory.

// The peers' slices of a cross-rank step: entry e of the item at local
// index l is ent[e][l].
template <class A>
__device__ __forceinline__ void cross_entries(A* amp, const GtCross& x,
                                              A* ent[4]) {
    cg::cluster_group cl = cg::this_cluster();
#pragma unroll
    for (int e = 0; e < 4; ++e)
        ent[e] = cl.map_shared_rank(amp, x.rk[e]) + x.off[e];
}

// A mat step's pairs on this rank (its own slice, or its share of a
// cross-rank group's pairs): op(a0, a1) updates a pair in place.
template <class A, class Op>
__device__ __forceinline__ void mat_pairs(A* amp, int L, unsigned rank,
                                          GtStep st, bool cross, Op op) {
    const int DL = 1 << L;
    const bool lctrl = st.ctrl && st.gb < L;
    if (!cross) {
        const int bit = 1 << st.ga;
        for (int j = threadIdx.x; j < (DL >> 1); j += QG_THREADS) {
            const int i0 = insert0(j, st.ga);
            if (lctrl && !((i0 >> st.gb) & 1)) continue;
            A a0 = amp[i0], a1 = amp[i0 | bit];
            op(a0, a1);
            amp[i0] = a0;
            amp[i0 | bit] = a1;
        }
        return;
    }
    const GtCross x = cross_plan(st, L, rank);
    A* ent[4];
    cross_entries(amp, x, ent);
    for (int j = threadIdx.x; j < x.n_items; j += QG_THREADS) {
        const int l = cross_local(x, j, L);
        if (lctrl && !((l >> st.gb) & 1)) continue;
        A a0 = ent[0][l], a1 = ent[1][l];
        op(a0, a1);
        ent[0][l] = a0;
        ent[1][l] = a1;
    }
}

// A u2q step's quads on this rank: op(v) updates a quad's four amplitudes,
// in (bit_a, bit_b) order 00, 01, 10, 11, in place.
template <class A, class Op>
__device__ __forceinline__ void u2q_quads(A* amp, int L, unsigned rank,
                                          GtStep st, bool cross, Op op) {
    const int DL = 1 << L;
    if (!cross) {
        for (int q = threadIdx.x; q < (DL >> 2); q += QG_THREADS) {
            int idx[4];
            quad_index(q, st.ga, st.gb, idx);
            A v[4] = {amp[idx[0]], amp[idx[1]], amp[idx[2]], amp[idx[3]]};
            op(v);
#pragma unroll
            for (int c = 0; c < 4; ++c) amp[idx[c]] = v[c];
        }
        return;
    }
    const GtCross x = cross_plan(st, L, rank);
    A* ent[4];
    cross_entries(amp, x, ent);
    for (int j = threadIdx.x; j < x.n_items; j += QG_THREADS) {
        const int l = cross_local(x, j, L);
        A v[4] = {ent[0][l], ent[1][l], ent[2][l], ent[3][l]};
        op(v);
#pragma unroll
        for (int c = 0; c < 4; ++c) ent[c][l] = v[c];
    }
}

// (a, b) <- (m00 a + m01 b, m10 a + m11 b); m holds re/im of m00, m01,
// m10, m11.
__device__ __forceinline__ void mul2(const float* m, float& ar, float& ai,
                                     float& br, float& bi) {
    float y0r, y0i, y1r, y1i;
    cmadd2(m[0], m[1], ar, ai, m[2], m[3], br, bi, y0r, y0i);
    cmadd2(m[4], m[5], ar, ai, m[6], m[7], br, bi, y1r, y1i);
    ar = y0r;
    ai = y0i;
    br = y1r;
    bi = y1i;
}

// v[r] <- sum_c U[r][c] v[c] (or conj(U[c][r]) when CT) on a quad's (re, im)
// parts vr, vi; u is a [32] bank row, the 16 complex entries row-major.
template <bool CT>
__device__ __forceinline__ void mul4(float vr[4], float vi[4], const float* u) {
    float outr[4], outi[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        float accr = 0.f, acci = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int e = CT ? (c * 4 + r) * 2 : (r * 4 + c) * 2;
            const float ur = u[e];
            const float ui = CT ? -u[e + 1] : u[e + 1];
            accr = fmaf(ur, vr[c], fmaf(-ui, vi[c], accr));
            acci = fmaf(ur, vi[c], fmaf(ui, vr[c], acci));
        }
        outr[r] = accr;
        outi[r] = acci;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        vr[r] = outr[r];
        vi[r] = outi[r];
    }
}

// Add the block's sums of v[8] into out[0..8), in a fixed order: a
// butterfly in each warp that halves the vector at lane offsets 16, 8, 4
// (9 shuffles), then thread e adds the warps' element e in warp order.
// red holds QG_THREADS / 32 * 8 floats of shared memory.
__device__ __forceinline__ void block_add8(float v[8], float* red, float* out) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int h = 4, off = 16; h >= 1; h >>= 1, off >>= 1) {
        const bool up = lane & off;
#pragma unroll
        for (int k = 0; k < h; ++k) {
            const float send = up ? v[k] : v[k + h];
            const float keep = up ? v[k + h] : v[k];
            v[k] = keep + __shfl_xor_sync(0xffffffffu, send, off);
        }
    }
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], 2);
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
    // lanes 4e .. 4e + 3 hold the warp's sum of element e
    if ((lane & 3) == 0) red[warp * 8 + (lane >> 2)] = v[0];
    __syncthreads();
    if (threadIdx.x < 8) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < QG_THREADS / 32; ++w) s += red[w * 8 + threadIdx.x];
        out[threadIdx.x] += s;
    }
}

// One forward step on this rank's amplitudes.
__device__ __forceinline__ void fwd_step(float2* amp, int L, unsigned rank,
                                         int D, GtStep st, bool cross,
                                         const float* __restrict__ mats,
                                         const float* __restrict__ u4,
                                         const float* __restrict__ cosb,
                                         const float* __restrict__ sinb) {
    const int DL = 1 << L;
    if (st.kind == 0) {
        if (rank_idle(st, L, rank)) return;
        float m[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) m[e] = mats[8 * st.idx + e];
        mat_pairs(amp, L, rank, st, cross,
                  [&](float2& a, float2& b) { mul2(m, a.x, a.y, b.x, b.y); });
    } else if (st.kind == 1) {
        // rank r's columns of the phase plane
        const size_t col = (size_t)st.idx * D + (size_t)rank * DL;
        const float* pc = cosb + col;
        const float* ps = sinb + col;
        for (int i = threadIdx.x; i < DL; i += QG_THREADS) {
            const float c = pc[i], s = ps[i];
            const float2 a = amp[i];
            amp[i] = make_float2(fmaf(a.x, c, -a.y * s), fmaf(a.x, s, a.y * c));
        }
    } else {
        const float* u = u4 + 32 * st.idx;
        u2q_quads(amp, L, rank, st, cross, [&](float2 v[4]) {
            float vr[4] = {v[0].x, v[1].x, v[2].x, v[3].x};
            float vi[4] = {v[0].y, v[1].y, v[2].y, v[3].y};
            mul4<false>(vr, vi, u);
#pragma unroll
            for (int c = 0; c < 4; ++c) v[c] = make_float2(vr[c], vi[c]);
        });
    }
}

extern "C" __global__ void __launch_bounds__(QG_THREADS, QG_FWD_MIN_BLOCKS)
gate_loop_fwd_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                     const float* __restrict__ mats, const float* __restrict__ u4,
                     const float* __restrict__ cosb,
                     const float* __restrict__ sinb, float* __restrict__ yr,
                     float* __restrict__ yi, int B, int n, int L, GtTable tab) {
    extern __shared__ float4 smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.dim_blocks().x;
    const unsigned rank = cluster.block_rank();
    const int D = 1 << n, DL = 1 << L;
    const int tid = threadIdx.x;
    float2* amp = reinterpret_cast<float2*>(smem);
    for (int b = blockIdx.x / C; b < B; b += gridDim.x / C) {
        const size_t base = (size_t)b * D + (size_t)rank * DL;
        for (int e = tid; e < DL; e += QG_THREADS)
            amp[e] = make_float2(xr[base + e], xi[base + e]);
        bool cross = tab.n_steps > 0 && cross_rank(decode(tab.step[0]), L);
        step_barrier(cross);
        for (int k = 0; k < tab.n_steps; ++k) {
            const GtStep st = decode(tab.step[k]);
            fwd_step(amp, L, rank, D, st, cross, mats, u4, cosb, sinb);
            const bool next = k + 1 < tab.n_steps && cross_rank(decode(tab.step[k + 1]), L);
            step_barrier(cross || next);
            cross = next;
        }
        for (int e = tid; e < DL; e += QG_THREADS) {
            const float2 a = amp[e];
            yr[base + e] = a.x;
            yi[base + e] = a.y;
        }
        step_barrier(C > 1);
    }
}

// One backward step (not a diag) on this rank's amplitudes; a mat step
// adds this thread's matrix-cotangent sums into acc.
__device__ __forceinline__ void bwd_step(float4* amp, int L, unsigned rank,
                                         GtStep st, bool cross,
                                         const float* __restrict__ mats,
                                         const float* __restrict__ u4,
                                         float acc[8]) {
    if (st.kind == 0) {
        if (rank_idle(st, L, rank)) return;
        // the inverse conj(M)^T in mul2's layout
        const float* m = mats + 8 * st.idx;
        const float a[8] = {m[0], -m[1], m[4], -m[5], m[2], -m[3], m[6], -m[7]};
        mat_pairs(amp, L, rank, st, cross, [&](float4& p0, float4& p1) {
            // recover the input x = M^-1 y
            mul2(a, p0.x, p0.y, p1.x, p1.y);
            const float x0r = p0.x, x0i = p0.y, x1r = p1.x, x1i = p1.y;
            const float g0r = p0.z, g0i = p0.w, g1r = p1.z, g1i = p1.w;
            // mbar[i][j] += g_i conj(x_j)
            acc[0] += g0r * x0r + g0i * x0i;
            acc[1] += g0i * x0r - g0r * x0i;
            acc[2] += g0r * x1r + g0i * x1i;
            acc[3] += g0i * x1r - g0r * x1i;
            acc[4] += g1r * x0r + g1i * x0i;
            acc[5] += g1i * x0r - g1r * x0i;
            acc[6] += g1r * x1r + g1i * x1i;
            acc[7] += g1i * x1r - g1r * x1i;
            // pull the cotangent back through M^-1
            mul2(a, p0.z, p0.w, p1.z, p1.w);
        });
    } else {
        const float* u = u4 + 32 * st.idx;
        u2q_quads(amp, L, rank, st, cross, [&](float4 v[4]) {
            float sr[4] = {v[0].x, v[1].x, v[2].x, v[3].x};
            float si[4] = {v[0].y, v[1].y, v[2].y, v[3].y};
            float qr[4] = {v[0].z, v[1].z, v[2].z, v[3].z};
            float qi[4] = {v[0].w, v[1].w, v[2].w, v[3].w};
            mul4<true>(sr, si, u);
            mul4<true>(qr, qi, u);
#pragma unroll
            for (int c = 0; c < 4; ++c) v[c] = make_float4(sr[c], si[c], qr[c], qi[c]);
        });
    }
}

extern "C" __global__ void __launch_bounds__(QG_THREADS)
gate_loop_bwd_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
                     const float* __restrict__ gr, const float* __restrict__ gi,
                     const float* __restrict__ mats, const float* __restrict__ u4,
                     const float* __restrict__ cosb,
                     const float* __restrict__ sinb, float* __restrict__ gxr,
                     float* __restrict__ gxi, float* __restrict__ partials,
                     int slab, int mats_len, int phase_len, int B, int n, int L,
                     GtTable tab) {
    extern __shared__ float4 smem[];
    __shared__ float red[(QG_THREADS / 32) * 8];
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.dim_blocks().x;
    const unsigned rank = cluster.block_rank();
    const int D = 1 << n, DL = 1 << L;
    const int tid = threadIdx.x;
    // the slice's (state, cotangent) per amplitude, then this CTA's [K, 8]
    // matrix cotangent summed over its samples
    float4* amp = smem;
    float* macc = reinterpret_cast<float*>(smem + DL);
    float* part = partials + (size_t)(blockIdx.x / C) * slab;
    // this rank's columns of the cluster's phase cotangents
    float* gcos = part + mats_len + (size_t)rank * DL;
    float* gsin = gcos + phase_len;
    const int planes = phase_len / D;
    for (int e = tid; e < mats_len; e += QG_THREADS) macc[e] = 0.f;
    for (int p = 0; p < planes; ++p)
        for (int e = tid; e < DL; e += QG_THREADS) {
            gcos[(size_t)p * D + e] = 0.f;
            gsin[(size_t)p * D + e] = 0.f;
        }
    __syncthreads();
    for (int b = blockIdx.x / C; b < B; b += gridDim.x / C) {
        const size_t base = (size_t)b * D + (size_t)rank * DL;
        for (int e = tid; e < DL; e += QG_THREADS)
            amp[e] = make_float4(yr[base + e], yi[base + e], gr[base + e], gi[base + e]);
        bool cross = tab.n_steps > 0 && cross_rank(decode(tab.step[tab.n_steps - 1]), L);
        step_barrier(cross);
        for (int k = tab.n_steps - 1; k >= 0; --k) {
            const GtStep st = decode(tab.step[k]);
            if (st.kind == 1) {
                const size_t col = (size_t)st.idx * D;
                const float* pc = cosb + col + (size_t)rank * DL;
                const float* ps = sinb + col + (size_t)rank * DL;
                float* gc = gcos + col;
                float* gs = gsin + col;
                // QG_DIAG_ILP amplitudes at a time, all loads first: the
                // phase planes and the slab come from L2
                for (int i0 = tid; i0 < DL; i0 += QG_DIAG_ILP * QG_THREADS) {
                    float c[QG_DIAG_ILP], s[QG_DIAG_ILP], hc[QG_DIAG_ILP], hs[QG_DIAG_ILP];
                    float4 v[QG_DIAG_ILP];
#pragma unroll
                    for (int t = 0; t < QG_DIAG_ILP; ++t) {
                        const int i = i0 + t * QG_THREADS;
                        if (i >= DL) break;
                        c[t] = pc[i];
                        s[t] = ps[i];
                        hc[t] = gc[i];
                        hs[t] = gs[i];
                        v[t] = amp[i];
                    }
#pragma unroll
                    for (int t = 0; t < QG_DIAG_ILP; ++t) {
                        const int i = i0 + t * QG_THREADS;
                        if (i >= DL) break;
                        // input recovery: conjugate phase
                        const float a = fmaf(c[t], v[t].x, s[t] * v[t].y);
                        const float d = fmaf(c[t], v[t].y, -s[t] * v[t].x);
                        const float u = v[t].z, w = v[t].w;
                        // phase cotangents (out = (c + i s) * in)
                        gc[i] = hc[t] + (u * a + w * d);
                        gs[i] = hs[t] + (-u * d + w * a);
                        amp[i] = make_float4(a, d, fmaf(c[t], u, s[t] * w),
                                             fmaf(c[t], w, -s[t] * u));
                    }
                }
            } else {
                float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
                bwd_step(amp, L, rank, st, cross, mats, u4, acc);
                if (st.kind == 0) block_add8(acc, red, macc + 8 * st.idx);
            }
            const bool next = k > 0 && cross_rank(decode(tab.step[k - 1]), L);
            step_barrier(cross || next);
            cross = next;
        }
        for (int e = tid; e < DL; e += QG_THREADS) {
            const float4 v = amp[e];
            gxr[base + e] = v.z;
            gxi[base + e] = v.w;
        }
        step_barrier(C > 1);
    }
    // the cluster's matrix cotangent: rank 0 adds the ranks' sums in rank
    // order; no CTA leaves while rank 0 reads its sums
    step_barrier(C > 1);
    if (rank == 0) cluster_rank_sum(macc, part, mats_len);
    step_barrier(C > 1);
}

static size_t fwd_smem_done[GT_MAX_DEVICES];
static size_t bwd_smem_done[GT_MAX_DEVICES];

extern "C" const char* qc_gate_loop_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Dynamic shared memory per CTA: the slice's state (forward), its state and
// cotangent and the CTA's [K, 8] matrix sums (backward).
static size_t smem_bytes(int bwd, int L, int mats_len) {
    const size_t d = (size_t)1 << L;
    return sizeof(float) * (bwd ? 4 * d + (size_t)mats_len : 2 * d);
}

// A cluster of 2^(n - L) CTAs, at most 8 (the portable cluster size); a
// cross-rank step splits its items on local bits L - 1 and L - 2.
static int check_partition(int n, int L) {
    if (n < 1 || L < 1 || L > n || n - L > 3 || (n > L && L < 3))
        return (int)cudaErrorInvalidValue;
    return 0;
}

// Opt the kernel in to its shared memory and fill a launch of `clusters`
// clusters of 2^(n - L) CTAs.
static int launch_config(int bwd, int n, int L, int mats_len, int clusters,
                         void* stream, cudaLaunchConfig_t* cfg,
                         cudaLaunchAttribute* attr) {
    int err = check_partition(n, L);
    if (err) return err;
    const void* kernel = bwd ? (const void*)gate_loop_bwd_kernel
                             : (const void*)gate_loop_fwd_kernel;
    const size_t smem = smem_bytes(bwd, L, mats_len);
    err = opt_in_smem(kernel, smem, bwd ? bwd_smem_done : fwd_smem_done);
    if (err) return err;
    const unsigned C = 1u << (n - L);
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = C;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    *cfg = cudaLaunchConfig_t{};
    cfg->gridDim = dim3(C * (unsigned)clusters);
    cfg->blockDim = dim3(QG_THREADS);
    cfg->dynamicSmemBytes = smem;
    cfg->stream = (cudaStream_t)stream;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
    return 0;
}

// The most clusters of the forward (bwd = 0) or backward kernel that the
// current device holds at once (mats_len: the backward's [K, 8] sums).
extern "C" int qc_gate_loop_max_clusters(int bwd, int n, int L, int mats_len,
                                         int* out) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    int err = launch_config(bwd, n, L, mats_len, 1, nullptr, &cfg, &attr);
    if (err) return err;
    const void* kernel = bwd ? (const void*)gate_loop_bwd_kernel
                             : (const void*)gate_loop_fwd_kernel;
    return (int)cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

extern "C" int qc_gate_loop_fwd(const float* xr, const float* xi,
                                const float* mats, const float* u4,
                                const float* cosb, const float* sinb, float* yr,
                                float* yi, int B, int n, int L,
                                const unsigned int* steps, int n_steps, int G,
                                void* stream) {
    GtTable tab;
    int err = fill_table(&tab, steps, n_steps);
    if (err) return err;
    if (G < 1) return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    err = launch_config(0, n, L, 0, G, stream, &cfg, &attr);
    if (err) return err;
    err = (int)cudaLaunchKernelEx(&cfg, gate_loop_fwd_kernel, xr, xi, mats, u4,
                                  cosb, sinb, yr, yi, B, n, L, tab);
    return err ? err : (int)cudaGetLastError();
}

extern "C" int qc_gate_loop_bwd(const float* yr, const float* yi,
                                const float* gr, const float* gi,
                                const float* mats, const float* u4,
                                const float* cosb, const float* sinb, float* gxr,
                                float* gxi, float* partials, int slab,
                                int mats_len, int phase_len, int B, int n, int L,
                                const unsigned int* steps, int n_steps, int G,
                                void* stream) {
    GtTable tab;
    int err = fill_table(&tab, steps, n_steps);
    if (err) return err;
    if (G < 1 || mats_len < 8 || phase_len % (1 << n))
        return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    err = launch_config(1, n, L, mats_len, G, stream, &cfg, &attr);
    if (err) return err;
    err = (int)cudaLaunchKernelEx(&cfg, gate_loop_bwd_kernel, yr, yi, gr, gi,
                                  mats, u4, cosb, sinb, gxr, gxi, partials, slab,
                                  mats_len, phase_len, B, n, L, tab);
    return err ? err : (int)cudaGetLastError();
}

// K6b (slab_sum.cuh).
extern "C" int qc_gate_loop_reduce(const float* partials, float* out, int slab,
                                   int G, void* stream) {
    return slab_sum_launch(partials, out, slab, G, stream);
}
