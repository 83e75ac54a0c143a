// Block-chain evolution kernels on a thread-block cluster, for Hopper
// (sm_90a): every plan the 12-qubit pair in block_chain.cu does not take.
//
// Replaces qcpinn_tpu/ops/block_pallas.py::_forward_kernel (K1) and
// ::_backward_kernel (K2) at 13 <= n <= 16 qubits, at n <= 9, and at any
// hi/lo split with a block narrower than 32 or wider than 128 (the 12q
// pair holds one sample and, backward, a whole [K, K] matrix in one CTA,
// and its tensor-core tiles are 32 rows deep). The plan and its packed
// inputs are the 12q pair's: a table of mat steps (contract the hi or lo
// axis of the split re/im state s[H][L] with a complex [K, K] matrix
// M[in, out]) and diag steps (multiply by cos + i sin phase planes).
//
// Where the state lives. One sample's state is 8 * 2^n bytes, 512 KB at 16
// qubits, and the backward holds its cotangent too. A cluster of C CTAs
// holds one sample in shared memory, split along the partition axis P
// (the wider of H and L): rank r keeps rows (or columns) [r D_P / C,
// (r + 1) D_P / C) as a local [Hl][Ll] slice, and reads the others'
// slices through distributed shared memory (DSMEM). C is the least power
// of two that keeps a CTA's state planes within 128 KB and a rank's share
// of any output fiber within the write-back buffer (cluster_config in
// ops/block_kernel.py): forward 1 / 1 / 2 / 4 CTAs at 13 / 14 / 15 / 16
// qubits, backward 1 / 2 / 4 / 8; C = 1 at n <= 12.
//
// A mat step is a product per sample: out(x, y) = sum_k M[k][x] s(k, y),
// with x along the stepped axis (K wide) and y along the other. If the
// stepped axis is P ("cross"), each rank computes its own x range for
// every y, reading the other ranks' rows; else each rank computes every x
// for its own y range from its own slice. The step runs in chunks of F
// fibers y: the chunk's outputs go into a write-back buffer, then (after a
// cluster barrier where a peer reads this rank's rows, else a CTA barrier)
// over the chunk's inputs in place. The matrices stay in device memory (L2:
// 2.6 MB at 16 qubits) and stream through the product's tiles.
//
// The products are one tiled complex GEMM on the FP32 units: a pass makes
// a TI x TJ tile (TI * TJ = 4096) with a 4x4 complex register tile a
// thread, staging 8 rows of each operand at a time in shared memory (a
// block narrower than a tile is padded with zeros and its padded outputs
// dropped). What bounds it: at 16 qubits a mat step is a 256x256x256
// complex product a sample (2 flop per byte of state per k), so the work is
// arithmetic; this first version is simple and right, not fast.
//
// The backward sweeps the plan in reverse from the final state, with the
// matrices conj-transposed (Mct): for each mat step it recovers the step's
// input (s <- contract(s, Mct)), adds dM[k][m] = sum_y conj(s(k, y)) g(m, y)
// for this sample into its cluster's slab (the K x K tiles split among the
// ranks, each entry owned by one rank), and pulls the cotangent back
// (g <- contract(g, Mct)); a diag step recovers, adds the phase cotangents
// of the rank's own elements and pulls back. A persistent grid of clusters
// takes samples c, c + G, ...; each cluster owns one slab and
// block_chain.cu's block_chain_reduce_kernel adds the G slabs in a fixed
// order, so two runs are bit-equal.
//
// Plain C interface (loaded with ctypes); every entry returns the launch's
// error (cudaLaunchKernelEx, then cudaGetLastError()).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace cg = cooperative_groups;

#define BC_MAX_STEPS 128
#define BC_THREADS 256
#define BC_TILE 4096  // complex outputs of one GEMM pass: 4x4 a thread
#define BC_TP 8       // rows of the contracted index staged a pass
#define BC_TMAX 256   // the widest side of a tile
#define BC_OUT 4096   // complex entries of the write-back buffer
#define BC_MAX_CLUSTER 8
#define BC_MAX_DEVICES 64

struct BcPlan {
    int n_steps;
    int kind[BC_MAX_STEPS];  // 0 = mat, 1 = diag
    int axis[BC_MAX_STEPS];  // 0 = hi, 1 = lo (mat only)
    int off[BC_MAX_STEPS];   // float offset into the packed mats / phases
};

// One rank's view of the sample the cluster holds.
struct Part {
    int n, hb, lb;
    int C, rank;
    int part_hi;  // 1: the ranks split H; 0: they split L
    int lh, ll;   // log2 of the local slice [Hl][Ll]
    int NL;       // floats in one local plane: 2^n / C
    float* smem;  // this rank's planes, NL floats each
};

__device__ __forceinline__ Part make_part(float* smem, int hb, int lb, int part_hi) {
    cg::cluster_group cl = cg::this_cluster();
    Part q;
    q.n = hb + lb;
    q.hb = hb;
    q.lb = lb;
    q.C = (int)cl.dim_blocks().x;
    q.rank = (int)cl.block_rank();
    const int c = __ffs(q.C) - 1;
    q.part_hi = part_hi;
    q.lh = part_hi ? hb - c : hb;
    q.ll = part_hi ? lb : lb - c;
    q.NL = 1 << (q.n - c);
    q.smem = smem;
    return q;
}

// The barrier between phases that read other ranks' slices (the whole
// cluster) or only this CTA's.
__device__ __forceinline__ void sync_part(bool cluster_wide) {
    if (cluster_wide)
        cg::this_cluster().sync();
    else
        __syncthreads();
}

// The local index of global element (h, l) in its owner's slice.
__device__ __forceinline__ int local_idx(const Part& q, int h, int l) {
    return ((h & ((1 << q.lh) - 1)) << q.ll) | (l & ((1 << q.ll) - 1));
}

// The global (h, l) of this rank's local element e.
__device__ __forceinline__ void global_hl(const Part& q, int e, int& h, int& l) {
    h = e >> q.ll;
    l = e & ((1 << q.ll) - 1);
    if (q.part_hi)
        h += q.rank << q.lh;
    else
        l += q.rank << q.ll;
}

// Element (x, y) of state pair `pair` (planes 2 pair, 2 pair + 1), x along
// H when hi, else along L; read from whichever rank holds it.
__device__ __forceinline__ float2 state_get(const Part& q, int pair, bool hi, int x,
                                            int y) {
    const int h = hi ? x : y, l = hi ? y : x;
    const int r = q.part_hi ? (h >> q.lh) : (l >> q.ll);
    const float* base = q.smem;
    if (r != q.rank) base = cg::this_cluster().map_shared_rank(q.smem, (unsigned)r);
    const float* e = base + (size_t)(2 * pair) * q.NL + local_idx(q, h, l);
    return make_float2(e[0], e[q.NL]);
}

// An operand of the tile GEMM, element (p, i) with p the contracted index
// and i the tile's free index from c0:
//   kind 0: M[p][c0 + i] of a packed [K][K] re / im pair in device memory;
//   kind 1: s(x = p, y = c0 + i) of state pair `pair`;
//   kind 2: conj s(x = c0 + i, y = p);
//   kind 3: s(x = c0 + i, y = p).
struct Src {
    int kind;
    const float* g;
    int K;
    int pair;
    bool hi;
    int c0;
};

__device__ __forceinline__ float2 src_load(const Src& s, const Part& q, int p, int i) {
    if (s.kind == 0) {
        const size_t e = (size_t)p * s.K + s.c0 + i;
        return make_float2(__ldg(s.g + e), __ldg(s.g + (size_t)s.K * s.K + e));
    }
    const bool pi = s.kind == 1;
    float2 v = state_get(q, s.pair, s.hi, pi ? p : s.c0 + i, pi ? s.c0 + i : p);
    if (s.kind == 2) v.y = -v.y;
    return v;
}

// True where consecutive p, not consecutive i, are adjacent in memory.
__device__ __forceinline__ bool p_contiguous(const Src& s) {
    return (s.kind == 1 && !s.hi) || (s.kind >= 2 && s.hi);
}

// Stage rows p0 .. p0 + BC_TP - 1 of an operand, i < W, into d[pp][W + 1]
// (re, then im BC_TP * (BC_TMAX + 1) floats on); zero past P or nw.
__device__ __forceinline__ void stage(const Src& s, const Part& q, int p0, int P, int W,
                                      int nw, float* dr, float* di) {
    const bool pc = p_contiguous(s);
    for (int e = threadIdx.x; e < BC_TP * W; e += BC_THREADS) {
        const int pp = pc ? e % BC_TP : e / W;
        const int w = pc ? e / BC_TP : e % W;
        float2 v = make_float2(0.f, 0.f);
        if (p0 + pp < P && w < nw) v = src_load(s, q, p0 + pp, w);
        dr[pp * (W + 1) + w] = v.x;
        di[pp * (W + 1) + w] = v.y;
    }
}

// acc(i, j) = sum_{p < P} A(p, i) B(p, j) over one TI x TJ tile (TI * TJ =
// BC_TILE, both powers of two in [16, BC_TMAX]); valid i < ni, j < nj.
// Thread (ty, tx) holds i = ty + R r, j = tx + Cc c, with R = TI / 4 and
// Cc = TJ / 4. Run by every thread of the CTA.
__device__ __forceinline__ void tile_gemm(const Src& a, const Src& b, const Part& q,
                                          int P, int TI, int TJ, int ni, int nj,
                                          float* tiles, float accr[4][4],
                                          float acci[4][4]) {
    const int R = TI / 4, Cc = TJ / 4;
    const int ty = threadIdx.x / Cc, tx = threadIdx.x % Cc;
    const int plane = BC_TP * (BC_TMAX + 1);
    float* ar = tiles;
    float* ai = ar + plane;
    float* br = ai + plane;
    float* bi = br + plane;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            accr[r][c] = 0.f;
            acci[r][c] = 0.f;
        }
    for (int p0 = 0; p0 < P; p0 += BC_TP) {
        stage(a, q, p0, P, TI, ni, ar, ai);
        stage(b, q, p0, P, TJ, nj, br, bi);
        __syncthreads();
        const int pe = min(BC_TP, P - p0);
        for (int pp = 0; pp < pe; ++pp) {
            float xr[4], xi[4], yr[4], yi[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                xr[r] = ar[pp * (TI + 1) + ty + R * r];
                xi[r] = ai[pp * (TI + 1) + ty + R * r];
            }
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                yr[c] = br[pp * (TJ + 1) + tx + Cc * c];
                yi[c] = bi[pp * (TJ + 1) + tx + Cc * c];
            }
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    accr[r][c] = fmaf(xr[r], yr[c], accr[r][c]);
                    accr[r][c] = fmaf(-xi[r], yi[c], accr[r][c]);
                    acci[r][c] = fmaf(xr[r], yi[c], acci[r][c]);
                    acci[r][c] = fmaf(xi[r], yr[c], acci[r][c]);
                }
        }
        __syncthreads();
    }
}

__device__ __forceinline__ int tile_rows(int X) {
    return X < 16 ? 16 : (X > BC_TMAX ? BC_TMAX : X);
}

// State pair `pair` <- contract(pair, M) along the hi or lo axis, in place;
// M is a packed [K][K] re / im pair in device memory. `out` holds 2 *
// BC_OUT floats.
__device__ void mat_step(const Part& q, int pair, bool hi, const float* M, float* out,
                         float* tiles) {
    const int kb = hi ? q.hb : q.lb;
    const int K = 1 << kb, Q = 1 << (q.n - kb);
    const bool cross = q.C > 1 && hi == (q.part_hi != 0);
    const bool split_y = q.C > 1 && !cross;
    const int Xn = cross ? K / q.C : K;
    const int x0 = cross ? q.rank * Xn : 0;
    const int Yn = split_y ? Q / q.C : Q;
    const int y0 = split_y ? q.rank * Yn : 0;
    const int F = min(Yn, BC_OUT / Xn);  // Xn <= BC_OUT (cluster_config)
    const int TI = tile_rows(Xn), TJ = BC_TILE / TI;
    const int R = TI / 4, Cc = TJ / 4;
    const int ty = threadIdx.x / Cc, tx = threadIdx.x % Cc;
    float* outr = out;
    float* outi = out + BC_OUT;
    float* sr = q.smem + (size_t)(2 * pair) * q.NL;
    float* si = sr + q.NL;
    for (int yc = y0; yc < y0 + Yn; yc += F) {
        for (int i0 = 0; i0 < Xn; i0 += TI)
            for (int j0 = 0; j0 < F; j0 += TJ) {
                const Src a{0, M, K, 0, hi, x0 + i0};
                const Src b{1, nullptr, K, pair, hi, yc + j0};
                float accr[4][4], acci[4][4];
                tile_gemm(a, b, q, K, TI, TJ, min(TI, Xn - i0), min(TJ, F - j0), tiles,
                          accr, acci);
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        const int i = i0 + ty + R * r, j = j0 + tx + Cc * c;
                        if (i < Xn && j < F) {
                            // the order the write-back walks the state in
                            const int o = hi ? i * F + j : j * Xn + i;
                            outr[o] = accr[r][c];
                            outi[o] = acci[r][c];
                        }
                    }
            }
        // every reader of the chunk's inputs (the cluster where cross) is done
        sync_part(cross);
        for (int e = threadIdx.x; e < Xn * F; e += BC_THREADS) {
            const int i = hi ? e / F : e % Xn;
            const int j = hi ? e % F : e / Xn;
            const int x = x0 + i, y = yc + j;
            const int idx = hi ? local_idx(q, x, y) : local_idx(q, y, x);
            sr[idx] = outr[e];
            si[idx] = outi[e];
        }
        __syncthreads();
    }
}

// slab[k][m] (re K*K floats, then im) += sum_y conj s(k, y) g(m, y) for
// this sample, s state pair 0 and g pair 1; the K x K tiles go round the
// ranks, so each entry has one writer.
__device__ void dm_step(const Part& q, bool hi, float* slab, float* tiles) {
    const int kb = hi ? q.hb : q.lb;
    const int K = 1 << kb, Q = 1 << (q.n - kb);
    const int TI = K >= 64 ? 64 : tile_rows(K), TJ = BC_TILE / TI;
    const int R = TI / 4, Cc = TJ / 4;
    const int ty = threadIdx.x / Cc, tx = threadIdx.x % Cc;
    const int nti = (K + TI - 1) / TI, ntj = (K + TJ - 1) / TJ;
    for (int t = q.rank; t < nti * ntj; t += q.C) {
        const int i0 = (t / ntj) * TI, j0 = (t % ntj) * TJ;
        const Src a{2, nullptr, K, 0, hi, i0};
        const Src b{3, nullptr, K, 1, hi, j0};
        float accr[4][4], acci[4][4];
        tile_gemm(a, b, q, Q, TI, TJ, min(TI, K - i0), min(TJ, K - j0), tiles, accr, acci);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int i = i0 + ty + R * r, j = j0 + tx + Cc * c;
                if (i < K && j < K) {
                    const size_t e = (size_t)i * K + j;
                    slab[e] += accr[r][c];
                    slab[(size_t)K * K + e] += acci[r][c];
                }
            }
    }
}

extern "C" __global__ void __launch_bounds__(BC_THREADS, 1)
block_cluster_fwd_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                         const float* __restrict__ mats,
                         const float* __restrict__ phases, float* __restrict__ yr,
                         float* __restrict__ yi, int B, int hb, int lb, int part_hi,
                         BcPlan plan) {
    extern __shared__ __align__(16) float smem[];
    const Part q = make_part(smem, hb, lb, part_hi);
    float* out = smem + 2 * (size_t)q.NL;
    float* tiles = out + 2 * BC_OUT;
    const bool multi = q.C > 1;
    const int G = gridDim.x / q.C, cid = blockIdx.x / q.C;
    const int HL = 1 << q.n, L = 1 << lb;
    for (int b = cid; b < B; b += G) {
        const size_t base = (size_t)b * HL;
        for (int e = threadIdx.x; e < q.NL; e += BC_THREADS) {
            int h, l;
            global_hl(q, e, h, l);
            smem[e] = xr[base + (size_t)h * L + l];
            smem[q.NL + e] = xi[base + (size_t)h * L + l];
        }
        sync_part(multi);
        for (int st = 0; st < plan.n_steps; ++st) {
            if (plan.kind[st] == 0) {
                mat_step(q, 0, plan.axis[st] == 0, mats + plan.off[st], out, tiles);
            } else {
                const float* pc = phases + plan.off[st];
                const float* ps = pc + HL;
                for (int e = threadIdx.x; e < q.NL; e += BC_THREADS) {
                    int h, l;
                    global_hl(q, e, h, l);
                    const float c = pc[h * L + l], s = ps[h * L + l];
                    const float a = smem[e], d = smem[q.NL + e];
                    smem[e] = a * c - d * s;
                    smem[q.NL + e] = a * s + d * c;
                }
            }
            sync_part(multi);
        }
        for (int e = threadIdx.x; e < q.NL; e += BC_THREADS) {
            int h, l;
            global_hl(q, e, h, l);
            yr[base + (size_t)h * L + l] = smem[e];
            yi[base + (size_t)h * L + l] = smem[q.NL + e];
        }
        __syncthreads();
    }
}

extern "C" __global__ void __launch_bounds__(BC_THREADS, 1)
block_cluster_bwd_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
                         const float* __restrict__ gr, const float* __restrict__ gi,
                         const float* __restrict__ matcts,
                         const float* __restrict__ phases, float* __restrict__ gxr,
                         float* __restrict__ gxi, float* __restrict__ partials,
                         int slab, int mats_total, int B, int hb, int lb, int part_hi,
                         BcPlan plan) {
    // planes: s re, s im, g re, g im; then the write-back buffer and tiles
    extern __shared__ __align__(16) float smem[];
    const Part q = make_part(smem, hb, lb, part_hi);
    float* out = smem + 4 * (size_t)q.NL;
    float* tiles = out + 2 * BC_OUT;
    const bool multi = q.C > 1;
    const int G = gridDim.x / q.C, cid = blockIdx.x / q.C;
    const int HL = 1 << q.n, L = 1 << lb;
    const int NL = q.NL;
    float* part = partials + (size_t)cid * slab;
    for (int e = q.rank * BC_THREADS + threadIdx.x; e < slab; e += q.C * BC_THREADS)
        part[e] = 0.f;
    __threadfence();
    sync_part(multi);
    for (int b = cid; b < B; b += G) {
        const size_t base = (size_t)b * HL;
        for (int e = threadIdx.x; e < NL; e += BC_THREADS) {
            int h, l;
            global_hl(q, e, h, l);
            const size_t gidx = base + (size_t)h * L + l;
            smem[e] = yr[gidx];
            smem[NL + e] = yi[gidx];
            smem[2 * NL + e] = gr[gidx];
            smem[3 * NL + e] = gi[gidx];
        }
        sync_part(multi);
        for (int st = plan.n_steps - 1; st >= 0; --st) {
            if (plan.kind[st] == 0) {
                const bool hi = plan.axis[st] == 0;
                const float* mct = matcts + plan.off[st];
                mat_step(q, 0, hi, mct, out, tiles);  // input recovery
                sync_part(multi);
                dm_step(q, hi, part + plan.off[st], tiles);
                sync_part(multi);
                mat_step(q, 1, hi, mct, out, tiles);  // cotangent pullback
            } else {
                const float* pc = phases + plan.off[st];
                const float* ps = pc + HL;
                float* gc = part + mats_total + plan.off[st];
                float* gs = gc + HL;
                for (int e = threadIdx.x; e < NL; e += BC_THREADS) {
                    int h, l;
                    global_hl(q, e, h, l);
                    const int pidx = h * L + l;
                    const float c = pc[pidx], s = ps[pidx];
                    const float sr = smem[e], si = smem[NL + e];
                    // input recovery: conjugate phase
                    const float a = c * sr + s * si;
                    const float d = c * si - s * sr;
                    smem[e] = a;
                    smem[NL + e] = d;
                    const float u = smem[2 * NL + e], v = smem[3 * NL + e];
                    // phase cotangents (out = (c + i s) * in)
                    gc[pidx] += u * a + v * d;
                    gs[pidx] += -u * d + v * a;
                    smem[2 * NL + e] = c * u + s * v;
                    smem[3 * NL + e] = c * v - s * u;
                }
            }
            sync_part(multi);
        }
        for (int e = threadIdx.x; e < NL; e += BC_THREADS) {
            int h, l;
            global_hl(q, e, h, l);
            const size_t gidx = base + (size_t)h * L + l;
            gxr[gidx] = smem[2 * NL + e];
            gxi[gidx] = smem[3 * NL + e];
        }
        __syncthreads();
    }
}

static int fill_plan(BcPlan* plan, const int* steps, int n_steps) {
    if (n_steps < 0 || n_steps > BC_MAX_STEPS) return (int)cudaErrorInvalidValue;
    plan->n_steps = n_steps;
    for (int i = 0; i < n_steps; ++i) {
        plan->kind[i] = steps[3 * i];
        plan->axis[i] = steps[3 * i + 1];
        plan->off[i] = steps[3 * i + 2];
    }
    return 0;
}

// Shared floats of one CTA: its state planes, the write-back buffer and the
// GEMM's staged tiles (cluster_config in ops/block_kernel.py mirrors this).
static size_t bc_floats(int planes, int NL) {
    return (size_t)planes * NL + 2 * BC_OUT + 4 * BC_TP * (BC_TMAX + 1);
}

static size_t fwd_smem_done[BC_MAX_DEVICES];
static size_t bwd_smem_done[BC_MAX_DEVICES];

// Opt a kernel in to `smem` bytes of dynamic shared memory on the current
// device, once per device and size.
static int opt_in_smem(const void* kernel, size_t smem, size_t* done) {
    int dev = 0;
    int err = (int)cudaGetDevice(&dev);
    if (err) return err;
    if (dev >= BC_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (smem <= done[dev]) return 0;
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (!err) done[dev] = smem;
    return err;
}

// Check a plan's shape against the kernel's buffers (cluster_config in
// ops/block_kernel.py picks C so that these hold) and fill the launch
// configuration of G clusters of C CTAs.
static int launch_config(int bwd, int hb, int lb, int C, int part_hi, int G,
                         void* stream, cudaLaunchConfig_t* cfg,
                         cudaLaunchAttribute* attr) {
    const int n = hb + lb;
    if (hb < 1 || lb < 1 || n > 16 || C < 1 || C > BC_MAX_CLUSTER || (C & (C - 1)) ||
        G < 1)
        return (int)cudaErrorInvalidValue;
    const int c = __builtin_ctz(C);
    const int dp = part_hi ? hb : lb, dq = part_hi ? lb : hb;
    if (C > 1 && dp < c) return (int)cudaErrorInvalidValue;
    // a rank's share of a fiber's outputs fits the write-back buffer
    const int xn_cross = 1 << (dp - c), xn_local = 1 << (C > 1 ? dq : dp > dq ? dp : dq);
    if (xn_cross > BC_OUT || xn_local > BC_OUT) return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * bc_floats(bwd ? 4 : 2, 1 << (n - c));
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    const void* kernel = bwd ? (const void*)block_cluster_bwd_kernel
                             : (const void*)block_cluster_fwd_kernel;
    int err = opt_in_smem(kernel, smem, bwd ? bwd_smem_done : fwd_smem_done);
    if (err) return err;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = (unsigned)C;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    *cfg = cudaLaunchConfig_t{};
    cfg->gridDim = dim3((unsigned)(C * G));
    cfg->blockDim = dim3(BC_THREADS);
    cfg->dynamicSmemBytes = smem;
    cfg->stream = (cudaStream_t)stream;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
    return 0;
}

extern "C" const char* qc_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// The most clusters of the forward (bwd = 0) or backward kernel that the
// current device holds at once.
extern "C" int qc_block_cluster_max_clusters(int bwd, int hb, int lb, int C,
                                             int part_hi, int* out) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    int err = launch_config(bwd, hb, lb, C, part_hi, 1, nullptr, &cfg, &attr);
    if (err) return err;
    const void* kernel = bwd ? (const void*)block_cluster_bwd_kernel
                             : (const void*)block_cluster_fwd_kernel;
    return (int)cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

extern "C" int qc_block_cluster_fwd(const float* xr, const float* xi,
                                    const float* mats, const float* phases,
                                    float* yr, float* yi, int B, int hb, int lb,
                                    int C, int part_hi, const int* steps,
                                    int n_steps, int G, void* stream) {
    BcPlan plan;
    int err = fill_plan(&plan, steps, n_steps);
    if (err) return err;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    err = launch_config(0, hb, lb, C, part_hi, G, stream, &cfg, &attr);
    if (err) return err;
    err = (int)cudaLaunchKernelEx(&cfg, block_cluster_fwd_kernel, xr, xi, mats,
                                  phases, yr, yi, B, hb, lb, part_hi, plan);
    return err ? err : (int)cudaGetLastError();
}

extern "C" int qc_block_cluster_bwd(const float* yr, const float* yi,
                                    const float* gr, const float* gi,
                                    const float* matcts, const float* phases,
                                    float* gxr, float* gxi, float* partials,
                                    int slab, int mats_total, int B, int hb,
                                    int lb, int C, int part_hi, const int* steps,
                                    int n_steps, int G, void* stream) {
    BcPlan plan;
    int err = fill_plan(&plan, steps, n_steps);
    if (err) return err;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    err = launch_config(1, hb, lb, C, part_hi, G, stream, &cfg, &attr);
    if (err) return err;
    err = (int)cudaLaunchKernelEx(&cfg, block_cluster_bwd_kernel, yr, yi, gr, gi,
                                  matcts, phases, gxr, gxi, partials, slab,
                                  mats_total, B, hb, lb, part_hi, plan);
    return err ? err : (int)cudaGetLastError();
}
