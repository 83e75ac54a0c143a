// The Cz engine's wire-group product (qcpinn_tpu_torch/ops/wire_group.py),
// forward and reverse, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this product to XLA's
// einsum (qcpinn_tpu/models/czochralski.py _apply_wire_group). On the card
// torch's einsum permuted the state into a contiguous copy before a
// complex GEMM for three of the four groups, and its reverse did the same.
//
// The product: a state [R, 2^n] complex64 viewed as [R, L, G, H] (L =
// 2^w0, G = 2^k with k <= 4, H = 2^(n - w0 - k)),
//   out[r, l, i, h] = sum_j U[u(r)][i, j] s[r % s_rows, l, j, h],
// with U [Nu, G, G] and u(r) = r / (R / Nu): one shared unitary (Nu = 1),
// one a row (Nu = R) or one a vmapped evaluation of R / Nu rows. The
// reverse reads the output's cotangent g and s once each and gives
//   grad_s = U^H g              (per row, written [R, 2^n]),
//   grad_U[u] = sum over u's rows, l, h of g s^H   (per-CTA partials
//                                 [P, Nu, G, G], then slab_sum.cuh).
//
// What bounds it: device memory. An output amplitude is G complex
// multiply-adds (128 flops at G = 16) for 16 bytes (8 read, 8 written):
// 8 flops a byte against the card's 67 TFLOP/s FP32 over 3.35 TB/s (20), so
// at the byte bound the FMA pipes run at about 40%. The reverse is 24 bytes
// and 256 flops an amplitude, about 55%. The design reads each state once
// and writes it once, never permuting it, in FP32 FMAs (no tensor cores).
//
// Design. Where H >= 32 the forward needs no staging
// (wire_group_fwd_direct_kernel): a thread takes two adjacent columns
// (column = one (l, h)), loads their G inputs each with 16-byte loads that
// coalesce across the warp, and writes the G outputs from registers, U
// read from shared memory by broadcast. Elsewhere, and in the reverse, a
// tile is W columns of the G rows j, T = G W <= 2048 amplitudes. Where H >= W the tile is one run of W amplitudes
// in each of the G rows of one l ("wide"); where H < W it is W / H whole
// [G, H] blocks, contiguous in memory ("narrow": H = 16 at w0 = 8 and H = 1
// at w0 = 12 of 16 qubits). Either way it is [NBK blocks][G rows][Hm] with
// Hm = min(H, W), staged in shared memory with 16-byte cp.async copies
// (coalesced in both layouts) in a ring of stages, so the next tiles load
// while this one is multiplied. A thread takes V = 2 adjacent columns (V =
// 1 where H = 1) and G / S of the output rows: it reads its columns' G
// inputs into registers, and after a barrier multiplies them by rows of U
// (16-byte broadcast loads from shared memory) and writes its outputs in
// place; the tile then leaves with coalesced 16-byte stores. Rows pad by 2
// amplitudes where Hm >= 8 and blocks by 2, so neither the columns' loads
// nor the reverse's row loads meet bank conflicts beyond the 16-byte
// minimum. A CTA walks `per` consecutive tiles of one unitary, so it loads
// its U once; the grid is one wave of CTAs where the tiles allow it.
//
// The reverse's grad_U: each thread holds a BI x BI block of (i, j) (BI =
// min(4, G), rows i = ib + NB a, columns j = jb + NB b, NB = G / BI) and
// sums g s^H over every NCG-th column vector of the tile, NCG = 256 / NB^2
// column groups, across the CTA's tiles; at the end the column groups add
// in order through shared memory into the CTA's partial, and the slab sum
// adds the partials in order: the same bits on every run.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "slab_sum.cuh"

#define WG_THREADS 256
#define WG_TILE 2048      // amplitudes a tile at most
#define WG_FWD_STAGES 3
#define WG_BWD_STAGES 2   // each stage holds g's and s's tiles

struct WgPlan {
    int n, w0, k, G;
    int lgG, lgH, lgHm, lgW;
    int H, W, Hm, T;
    int RP, BP, stage;        // row and block pitch, a stage's tile (amplitudes)
    int S;                    // output-row splits of a column vector
    int tiles_per_row, lg_tpr;
    int R, s_rows, Nu;
    int tiles_per_u, per, P;  // tiles a unitary, tiles a CTA, CTAs a unitary
};

static int wg_log2(long long v) {
    int l = 0;
    while ((1LL << l) < v) ++l;
    return l;
}

__device__ __forceinline__ void wg_cp16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void wg_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// acc += m x (complex)
__device__ __forceinline__ void wg_cmac(float2& acc, float mr, float mi, float2 x) {
    acc.x = fmaf(mr, x.x, acc.x);
    acc.x = fmaf(-mi, x.y, acc.x);
    acc.y = fmaf(mr, x.y, acc.y);
    acc.y = fmaf(mi, x.x, acc.y);
}

// acc += g conj(s)
__device__ __forceinline__ void wg_cmac_conj(float2& acc, float2 g, float2 s) {
    acc.x = fmaf(g.x, s.x, acc.x);
    acc.x = fmaf(g.y, s.y, acc.x);
    acc.y = fmaf(g.y, s.x, acc.y);
    acc.y = fmaf(-g.x, s.y, acc.y);
}

// The tile's first amplitude in its row: column q W of the row, column
// col = l H + h at l G H + h.
__device__ __forceinline__ long long wg_tile_base(const WgPlan& p, int q) {
    const long long col0 = (long long)q << p.lgW;
    return ((col0 >> p.lgH) << (p.lgG + p.lgH)) + (col0 & (p.H - 1));
}

// Chunk c (amplitudes 2c, 2c + 1 in the tile's [blk][j][hh] order): its
// offset from the tile's base in the row, and in the stage.
__device__ __forceinline__ void wg_chunk(const WgPlan& p, int c, long long* g_off, int* s_off) {
    const int e = 2 * c;
    const int hh = e & (p.Hm - 1);
    const int j = (e >> p.lgHm) & (p.G - 1);
    const int blk = e >> (p.lgHm + p.lgG);
    *g_off = ((long long)blk << (p.lgG + p.lgH)) + ((long long)j << p.lgH) + hh;
    *s_off = blk * p.BP + j * p.RP + hh;
}

// Tile `tile` (of all R tiles_per_row) of `src` (rows read as row % rows)
// into the stage buffer `buf`, by 16-byte cp.async.
__device__ __forceinline__ void wg_load_tile(const WgPlan& p, float2* buf, const float2* src,
                                             int rows, long long tile) {
    const long long row = tile >> p.lg_tpr;
    const int q = (int)(tile & (p.tiles_per_row - 1));
    const float2* base = src + (size_t)(row % rows) * ((size_t)1 << p.n) + wg_tile_base(p, q);
    for (int c = threadIdx.x; c < p.T / 2; c += WG_THREADS) {
        long long g_off;
        int s_off;
        wg_chunk(p, c, &g_off, &s_off);
        wg_cp16(buf + s_off, base + g_off);
    }
}

// The stage buffer `buf` out to tile `tile` of `dst` ([R, 2^n]).
__device__ __forceinline__ void wg_store_tile(const WgPlan& p, const float2* buf, float2* dst,
                                              long long tile) {
    const long long row = tile >> p.lg_tpr;
    const int q = (int)(tile & (p.tiles_per_row - 1));
    float2* base = dst + (size_t)row * ((size_t)1 << p.n) + wg_tile_base(p, q);
    for (int c = threadIdx.x; c < p.T / 2; c += WG_THREADS) {
        long long g_off;
        int s_off;
        wg_chunk(p, c, &g_off, &s_off);
        *reinterpret_cast<float4*>(base + g_off) = *reinterpret_cast<const float4*>(buf + s_off);
    }
}

// The tile in `buf` multiplied in place by M [G][G] (shared): every column
// x -> M x. Thread t takes column vector t % (W / V) and output rows
// [q G / S, (q + 1) G / S), q = t / (W / V). Holds one barrier between the
// reads and the writes; the caller's barriers fence the tile.
template <int G, int V>
__device__ __forceinline__ void wg_apply_tile(const WgPlan& p, float2* buf, const float2* M) {
    const int ncv = p.W / V;
    const int t = threadIdx.x;
    const bool live = t < ncv * p.S;
    const int cv = t & (ncv - 1), q = t / ncv;
    const int c = cv * V;
    float2* col = buf + (c >> p.lgHm) * p.BP + (c & (p.Hm - 1));
    float2 x[G][V];
    if (live) {
#pragma unroll
        for (int j = 0; j < G; ++j) {
            if (V == 2) {
                const float4 v = *reinterpret_cast<const float4*>(col + j * p.RP);
                x[j][0] = make_float2(v.x, v.y);
                x[j][V - 1] = make_float2(v.z, v.w);
            } else {
                x[j][0] = col[j * p.RP];
            }
        }
    }
    __syncthreads();  // every column read before any is overwritten
    if (!live) return;
    const int rows = G / p.S;
    for (int a = 0; a < rows; ++a) {
        const int i = q * rows + a;
        const float4* m = reinterpret_cast<const float4*>(M + i * G);
        float2 acc[V];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = make_float2(0.f, 0.f);
#pragma unroll
        for (int jj = 0; jj < G / 2; ++jj) {
            const float4 mm = m[jj];
#pragma unroll
            for (int v = 0; v < V; ++v) {
                wg_cmac(acc[v], mm.x, mm.y, x[2 * jj][v]);
                wg_cmac(acc[v], mm.z, mm.w, x[2 * jj + 1][v]);
            }
        }
        if (V == 2)
            *reinterpret_cast<float4*>(col + i * p.RP) =
                make_float4(acc[0].x, acc[0].y, acc[V - 1].x, acc[V - 1].y);
        else
            col[i * p.RP] = acc[0];
    }
}

template <int G, int V>
__global__ void __launch_bounds__(WG_THREADS, 2)
    wire_group_fwd_kernel(const float2* __restrict__ s, const float2* __restrict__ U,
                          float2* __restrict__ out, WgPlan p) {
    extern __shared__ __align__(16) float2 wg_smem[];
    float2* M = wg_smem;       // U[u] [G][G]
    float2* ring = M + G * G;  // WG_FWD_STAGES tiles
    const int u = blockIdx.x / p.P, part = blockIdx.x % p.P;
    const int first = part * p.per;
    const int count = min(p.per, p.tiles_per_u - first);
    const long long tile0 = (long long)u * p.tiles_per_u + first;
    for (int e = threadIdx.x; e < G * G; e += WG_THREADS) M[e] = U[(size_t)u * G * G + e];
    auto load_ahead = [&](int it) {
        if (it < count)
            wg_load_tile(p, ring + (it % WG_FWD_STAGES) * p.stage, s, p.s_rows, tile0 + it);
        wg_commit();
    };
#pragma unroll
    for (int it = 0; it < WG_FWD_STAGES - 1; ++it) load_ahead(it);
    for (int it = 0; it < count; ++it) {
        load_ahead(it + WG_FWD_STAGES - 1);  // into the stage the last tile left
        wg_wait<WG_FWD_STAGES - 1>();
        __syncthreads();  // tile it (and M) in shared memory
        float2* buf = ring + (it % WG_FWD_STAGES) * p.stage;
        wg_apply_tile<G, V>(p, buf, M);
        __syncthreads();  // the outputs written
        wg_store_tile(p, buf, out, tile0 + it);
        __syncthreads();  // the stage read out before it loads again
    }
}

// The forward where H >= 32 (the groups at w0 = 0 and 4 of 16 qubits): no
// staging. Thread t of a CTA takes the column pair 2 t, 2 t + 1 of its run
// in one row (consecutive threads, consecutive h: 16-byte loads that
// coalesce), holds its G x 2 inputs in registers and writes each output
// row as it is formed; U sits in shared memory, read by broadcast.
template <int G>
__global__ void __launch_bounds__(WG_THREADS)
    wire_group_fwd_direct_kernel(const float2* __restrict__ s, const float2* __restrict__ U,
                                 float2* __restrict__ out, WgPlan p) {
    __shared__ __align__(16) float2 M[G * G];
    const long long pair = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const int lg_pairs = p.n - p.lgG - 1;  // column pairs a row
    const long long row = pair >> lg_pairs;
    const int u = (int)(row / (p.R / p.Nu));
    for (int e = threadIdx.x; e < G * G; e += blockDim.x) M[e] = U[(size_t)u * G * G + e];
    const long long c = (pair & ((1LL << lg_pairs) - 1)) * 2;
    const long long off = ((c >> p.lgH) << (p.lgG + p.lgH)) + (c & (p.H - 1));
    const float2* src = s + (size_t)(row % p.s_rows) * ((size_t)1 << p.n) + off;
    float2* dst = out + (size_t)row * ((size_t)1 << p.n) + off;
    float4 x[G];
#pragma unroll
    for (int j = 0; j < G; ++j) x[j] = __ldg(reinterpret_cast<const float4*>(src + (size_t)j * p.H));
    __syncthreads();  // M in shared memory
#pragma unroll 4
    for (int i = 0; i < G; ++i) {
        const float4* m = reinterpret_cast<const float4*>(M + i * G);
        float2 a0 = make_float2(0.f, 0.f), a1 = make_float2(0.f, 0.f);
#pragma unroll
        for (int jj = 0; jj < G / 2; ++jj) {
            const float4 mm = m[jj];
            const float4 x0 = x[2 * jj], x1 = x[2 * jj + 1];
            wg_cmac(a0, mm.x, mm.y, make_float2(x0.x, x0.y));
            wg_cmac(a1, mm.x, mm.y, make_float2(x0.z, x0.w));
            wg_cmac(a0, mm.z, mm.w, make_float2(x1.x, x1.y));
            wg_cmac(a1, mm.z, mm.w, make_float2(x1.z, x1.w));
        }
        *reinterpret_cast<float4*>(dst + (size_t)i * p.H) = make_float4(a0.x, a0.y, a1.x, a1.y);
    }
}

template <int G, int V>
__global__ void __launch_bounds__(WG_THREADS, 2)
    wire_group_bwd_kernel(const float2* __restrict__ g, const float2* __restrict__ s,
                          const float2* __restrict__ U, float2* __restrict__ grad_s,
                          float2* __restrict__ partials, WgPlan p, int need_s, int need_u) {
    constexpr int BI = G < 4 ? G : 4, NB = G / BI, NCG = WG_THREADS / (NB * NB);
    extern __shared__ __align__(16) float2 wg_smem[];
    float2* Mh = wg_smem;       // U[u]^H [G][G]
    float2* ring = Mh + G * G;  // WG_BWD_STAGES x (g's tile, s's tile)
    const int u = blockIdx.x / p.P, part = blockIdx.x % p.P;
    const int first = part * p.per;
    const int count = min(p.per, p.tiles_per_u - first);
    const long long tile0 = (long long)u * p.tiles_per_u + first;
    for (int e = threadIdx.x; e < G * G; e += WG_THREADS) {
        const float2 v = U[(size_t)u * G * G + (e % G) * G + e / G];  // U[j][i] for (i, j)
        Mh[e] = make_float2(v.x, -v.y);
    }
    const int jb = threadIdx.x % NB, ib = (threadIdx.x / NB) % NB, cg = threadIdx.x / (NB * NB);
    float2 acc[BI][BI];
#pragma unroll
    for (int a = 0; a < BI; ++a)
#pragma unroll
        for (int b = 0; b < BI; ++b) acc[a][b] = make_float2(0.f, 0.f);
    auto load_ahead = [&](int it) {
        if (it < count) {
            float2* st = ring + (it % WG_BWD_STAGES) * 2 * p.stage;
            wg_load_tile(p, st, g, p.R, tile0 + it);
            if (need_u) wg_load_tile(p, st + p.stage, s, p.s_rows, tile0 + it);
        }
        wg_commit();
    };
#pragma unroll
    for (int it = 0; it < WG_BWD_STAGES - 1; ++it) load_ahead(it);
    const int ncv = p.W / V;
    for (int it = 0; it < count; ++it) {
        load_ahead(it + WG_BWD_STAGES - 1);
        wg_wait<WG_BWD_STAGES - 1>();
        __syncthreads();
        float2* gb = ring + (it % WG_BWD_STAGES) * 2 * p.stage;
        const float2* sb = gb + p.stage;
        if (need_u) {
            for (int cv = cg; cv < ncv; cv += NCG) {
                const int c = cv * V;
                const int off = (c >> p.lgHm) * p.BP + (c & (p.Hm - 1));
                float2 gv[BI][V], sv[BI][V];
#pragma unroll
                for (int a = 0; a < BI; ++a) {
                    const float2* gr = gb + off + (ib + NB * a) * p.RP;
                    const float2* sr = sb + off + (jb + NB * a) * p.RP;
                    if (V == 2) {
                        const float4 x = *reinterpret_cast<const float4*>(gr);
                        const float4 y = *reinterpret_cast<const float4*>(sr);
                        gv[a][0] = make_float2(x.x, x.y);
                        gv[a][V - 1] = make_float2(x.z, x.w);
                        sv[a][0] = make_float2(y.x, y.y);
                        sv[a][V - 1] = make_float2(y.z, y.w);
                    } else {
                        gv[a][0] = gr[0];
                        sv[a][0] = sr[0];
                    }
                }
#pragma unroll
                for (int v = 0; v < V; ++v)
#pragma unroll
                    for (int a = 0; a < BI; ++a)
#pragma unroll
                        for (int b = 0; b < BI; ++b) wg_cmac_conj(acc[a][b], gv[a][v], sv[b][v]);
            }
        }
        if (need_s) {
            wg_apply_tile<G, V>(p, gb, Mh);  // grad_s in place of g
            __syncthreads();
            wg_store_tile(p, gb, grad_s, tile0 + it);
        }
        __syncthreads();
    }
    if (!need_u) return;
    // the column groups' sums, added in order of the group
    float2* red = ring;  // [NCG][G][G]
#pragma unroll
    for (int a = 0; a < BI; ++a)
#pragma unroll
        for (int b = 0; b < BI; ++b)
            red[(cg * G + ib + NB * a) * G + jb + NB * b] = acc[a][b];
    __syncthreads();
    float2* dst = partials + ((size_t)part * p.Nu + u) * G * G;
    for (int e = threadIdx.x; e < G * G; e += WG_THREADS) {
        float2 sum = make_float2(0.f, 0.f);
        for (int c = 0; c < NCG; ++c) {
            sum.x += red[c * G * G + e].x;
            sum.y += red[c * G * G + e].y;
        }
        dst[e] = sum;
    }
}

// -- host ---------------------------------------------------------------------

typedef const void* WgKernel;  // a kernel's host stub, as the runtime takes it

static WgKernel wg_kernel(int bwd, int G, int V) {
#define WG_PICK(g)                                                              \
    if (G == g)                                                                 \
        return bwd ? (V == 2 ? (WgKernel)wire_group_bwd_kernel<g, 2>            \
                             : (WgKernel)wire_group_bwd_kernel<g, 1>)           \
                   : (V == 2 ? (WgKernel)wire_group_fwd_kernel<g, 2>            \
                             : (WgKernel)wire_group_fwd_kernel<g, 1>);
    WG_PICK(2)
    WG_PICK(4)
    WG_PICK(8)
    WG_PICK(16)
#undef WG_PICK
    return 0;
}

// The SM count and the CTAs an SM of kernel (bwd, k, V) at `bytes` of
// shared memory, asked once per device and size (the shapes of a step are
// met in its eager warm-ups, so a graph capture makes no such call).
#define WG_OCC_SIZES 8
struct WgOcc {
    size_t bytes[WG_OCC_SIZES];
    int per_sm[WG_OCC_SIZES];
    int used;
    size_t attr;  // the largest dynamic shared memory set on the kernel
};
static WgOcc wg_occ[SS_MAX_DEVICES][2][5][2];
static int wg_sms[SS_MAX_DEVICES];

static int wg_occupancy(int bwd, int k, int V, WgKernel kern, size_t bytes, int* sms,
                        int* per_sm) {
    int dev = 0;
    int err = (int)cudaGetDevice(&dev);
    if (err) return err;
    if (dev >= SS_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (!wg_sms[dev]) {
        err = (int)cudaDeviceGetAttribute(&wg_sms[dev], cudaDevAttrMultiProcessorCount, dev);
        if (err) return err;
    }
    *sms = wg_sms[dev];
    WgOcc* o = &wg_occ[dev][bwd][k][V - 1];
    for (int i = 0; i < o->used; ++i)
        if (o->bytes[i] == bytes) {
            *per_sm = o->per_sm[i];
            return 0;
        }
    if (bytes > o->attr) {
        err = (int)cudaFuncSetAttribute(kern,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err) return err;
        o->attr = bytes;
    }
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern,
                                                              WG_THREADS, bytes);
    if (err) return err;
    if (*per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const int slot = o->used < WG_OCC_SIZES ? o->used++ : WG_OCC_SIZES - 1;
    o->bytes[slot] = bytes;
    o->per_sm[slot] = *per_sm;
    return 0;
}

static bool wg_args_ok(int R, int s_rows, int n, int w0, int k, int Nu) {
    return n >= 1 && n <= 30 && k >= 1 && k <= 4 && w0 >= 0 && w0 + k <= n && R >= 1 &&
           Nu >= 1 && s_rows >= 1 && R % Nu == 0 && R % s_rows == 0;
}

// The plan of one call; fills *p, the dynamic shared memory and the kernel.
static int wg_plan(int R, int s_rows, int n, int w0, int k, int Nu, int bwd, WgPlan* p,
                   size_t* smem, WgKernel* kernel) {
    if (!wg_args_ok(R, s_rows, n, w0, k, Nu)) return (int)cudaErrorInvalidValue;
    WgPlan q = {};
    q.n = n;
    q.w0 = w0;
    q.k = k;
    q.G = 1 << k;
    q.lgG = k;
    q.H = 1 << (n - w0 - k);
    q.lgH = n - w0 - k;
    const int V = q.H >= 2 ? 2 : 1;
    long long W = WG_TILE / q.G;
    if (W > (long long)WG_THREADS * V) W = (long long)WG_THREADS * V;
    if (W > (1LL << (n - k))) W = 1LL << (n - k);
    q.W = (int)W;
    q.lgW = wg_log2(W);
    q.T = q.W * q.G;
    q.Hm = q.H < q.W ? q.H : q.W;
    q.lgHm = wg_log2(q.Hm);
    q.RP = q.Hm + (q.Hm >= 8 ? 2 : 0);
    q.BP = q.G * q.RP + 2;
    q.stage = (q.W / q.Hm) * q.BP;
    const int ncv = q.W / V;
    q.S = WG_THREADS / ncv;
    if (q.S > q.G) q.S = q.G;
    if (q.S < 1) q.S = 1;
    q.tiles_per_row = (int)((1LL << n) / q.T);
    q.lg_tpr = wg_log2(q.tiles_per_row);
    q.R = R;
    q.s_rows = s_rows;
    q.Nu = Nu;
    const long long tiles_per_u = (long long)(R / Nu) * q.tiles_per_row;
    if (tiles_per_u > INT_MAX) return (int)cudaErrorInvalidValue;
    q.tiles_per_u = (int)tiles_per_u;
    const int NB = q.G < 4 ? 1 : q.G / 4, NCG = WG_THREADS / (NB * NB);
    size_t ring = (size_t)(bwd ? 2 * WG_BWD_STAGES : WG_FWD_STAGES) * q.stage;
    if (bwd && ring < (size_t)NCG * q.G * q.G) ring = (size_t)NCG * q.G * q.G;
    const size_t bytes = sizeof(float2) * ((size_t)q.G * q.G + ring);
    WgKernel kern = wg_kernel(bwd, q.G, V);
    if (!kern) return (int)cudaErrorInvalidValue;
    int sms = 0, per_sm = 0;
    int err = wg_occupancy(bwd, k, V, kern, bytes, &sms, &per_sm);
    if (err) return err;
    // one wave of CTAs where the tiles allow it, each on one unitary's tiles
    const long long wave = (long long)sms * per_sm;
    const long long total = (long long)Nu * q.tiles_per_u;
    long long per = (total + wave - 1) / wave;
    if (per > q.tiles_per_u) per = q.tiles_per_u;
    if (per < 1) per = 1;
    q.per = (int)per;
    q.P = (int)((q.tiles_per_u + per - 1) / per);
    if ((long long)q.P * Nu > INT_MAX) return (int)cudaErrorInvalidValue;
    *p = q;
    *smem = bytes;
    *kernel = kern;
    return 0;
}

extern "C" const char* qc_wire_group_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// The reverse's partial count a unitary (P), for the caller's [P, Nu, G, G].
extern "C" int qc_wire_group_partials(int R, int s_rows, int n, int w0, int k, int Nu,
                                      int* P) {
    WgPlan p;
    size_t smem;
    WgKernel kern;
    const int err = wg_plan(R, s_rows, n, w0, k, Nu, 1, &p, &smem, &kern);
    if (!err) *P = p.P;
    return err;
}

static WgKernel wg_direct_kernel(int G) {
    if (G == 2) return (WgKernel)wire_group_fwd_direct_kernel<2>;
    if (G == 4) return (WgKernel)wire_group_fwd_direct_kernel<4>;
    if (G == 8) return (WgKernel)wire_group_fwd_direct_kernel<8>;
    if (G == 16) return (WgKernel)wire_group_fwd_direct_kernel<16>;
    return 0;
}

extern "C" int qc_wire_group_fwd(const void* s, const void* U, void* out, int R, int s_rows,
                                 int n, int w0, int k, int Nu, void* stream) {
    WgPlan p;
    size_t smem;
    WgKernel kern;
    int err = 0;
    if (!wg_args_ok(R, s_rows, n, w0, k, Nu)) return (int)cudaErrorInvalidValue;
    if (n - w0 - k >= 5) {
        // H >= 32: the direct kernel, a thread a column pair, a CTA in one row
        p = WgPlan{};
        p.n = n;
        p.G = 1 << k;
        p.lgG = k;
        p.lgH = n - w0 - k;
        p.H = 1 << p.lgH;
        p.R = R;
        p.s_rows = s_rows;
        p.Nu = Nu;
        const long long pairs = 1LL << (n - k - 1);  // a row's, >= 16
        const int threads = pairs < WG_THREADS ? (int)pairs : WG_THREADS;
        const long long blocks = (long long)R * pairs / threads;
        if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
        void* args[] = {(void*)&s, (void*)&U, (void*)&out, (void*)&p};
        err = (int)cudaLaunchKernel(wg_direct_kernel(p.G), dim3((unsigned)blocks),
                                    dim3(threads), args, 0, (cudaStream_t)stream);
        return err ? err : (int)cudaGetLastError();
    }
    err = wg_plan(R, s_rows, n, w0, k, Nu, 0, &p, &smem, &kern);
    if (err) return err;
    void* args[] = {(void*)&s, (void*)&U, (void*)&out, (void*)&p};
    err = (int)cudaLaunchKernel(kern, dim3(p.Nu * p.P), dim3(WG_THREADS), args,
                                smem, (cudaStream_t)stream);
    if (err) return err;
    return (int)cudaGetLastError();
}

// grad_s (when need_s) and, when need_u, the partials [P, Nu, G, G] and
// their fixed-order sum into grad_U [Nu, G, G]: two launches.
extern "C" int qc_wire_group_bwd(const void* g, const void* s, const void* U, void* grad_s,
                                 void* partials, void* grad_U, int R, int s_rows, int n, int w0,
                                 int k, int Nu, int need_s, int need_u, void* stream) {
    if (!need_s && !need_u) return 0;
    WgPlan p;
    size_t smem;
    WgKernel kern;
    int err = wg_plan(R, s_rows, n, w0, k, Nu, 1, &p, &smem, &kern);
    if (err) return err;
    void* args[] = {(void*)&g, (void*)&s, (void*)&U, (void*)&grad_s, (void*)&partials,
                    (void*)&p, (void*)&need_s, (void*)&need_u};
    err = (int)cudaLaunchKernel(kern, dim3(p.Nu * p.P), dim3(WG_THREADS), args,
                                smem, (cudaStream_t)stream);
    if (!err) err = (int)cudaGetLastError();
    if (err || !need_u) return err;
    return slab_sum_launch((const float*)partials, (float*)grad_U, p.Nu * p.G * p.G * 2, p.P,
                           stream);
}
