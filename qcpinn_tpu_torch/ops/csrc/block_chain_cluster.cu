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
// for its own y range from its own slice. The step runs in chunks of
// fibers y; a chunk's outputs wait in registers (or, where a rank's x
// range is wider than a tile, in the write-back buffer) until every reader
// of the chunk's inputs is done (a cluster barrier where a peer reads this
// rank's rows, else a CTA barrier), then overwrite them in place. The
// matrices stay in device memory (L2: 3.1 MB at 16 qubits) and stream
// through the product's tiles.
//
// What bounds it: at 16 qubits a mat step is a 256x256x256 complex product
// a sample, so the work is arithmetic. Every product (the contractions and
// dM) is one tiled complex GEMM on the tensor cores in 3xTF32
// (tf32_mma.cuh, K2's arithmetic): a pass makes a TI x TJ tile (TI * TJ =
// 8192, TI from 32 to 256), a 32 x 32 complex tile in registers for each
// of 8 consumer warps, over k-slabs of 16 or 24 rows of both operands
// staged in shared memory by 4 producer warps. Measured on an H100, loads and
// products issued by the same warps between CTA barriers did not overlap
// at all (their times added up), so the feed has warps of its own: the
// producers stage slab s + 1 (16-byte cp.async of the matrix rows from L2,
// float4 reads of the state from this rank's planes or a peer's through
// DSMEM, four runs in flight a thread) into one of two buffers while the
// consumers compute slab s from the other, handing the buffers over on
// named barriers. Each operand kind has its own straight-line loader.
// Staged rows have a stride of W + 8 floats, and each lane's fragment
// elements of a k-row are one float4 of A and two float2 of B (the lane
// picks which tile rows and columns its fragment slots stand for), so the
// fragment loads are few and conflict-free. The forward sums each k-step
// apart before adding it in f32 (cmma_half's FLUSH: the tensor cores round
// toward zero). A block narrower than a tile is padded with zeros and its
// padded outputs dropped.
//
// The backward sweeps the plan in reverse from the final state, with the
// matrices conj-transposed (Mct): for each mat step it recovers the step's
// input (s <- contract(s, Mct)), adds dM[k][m] = sum_y conj(s(k, y)) g(m, y)
// for this sample into its cluster's slab (the K x K tiles go round the
// ranks, each entry owned by one rank, each tile summed over y in
// registers before its one add), and pulls the cotangent back (g <-
// contract(g, Mct)); a diag step recovers, adds the phase cotangents of
// the rank's own elements and pulls back. A persistent grid of clusters
// takes samples c, c + G, ...; each cluster owns one slab and
// block_chain.cu's qc_block_chain_reduce (slab_sum.cuh) adds the G slabs
// in a fixed order, so two runs are bit-equal.
//
// Plain C interface (loaded with ctypes); every entry returns the launch's
// error (cudaLaunchKernelEx, then cudaGetLastError()).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace cg = cooperative_groups;

#define BC_MAX_STEPS 128
#define BC_CONSUMERS 256  // 8 warps: the products
#define BC_PRODUCERS 128  // 4 warps: the operand feed
#define BC_THREADS (BC_CONSUMERS + BC_PRODUCERS)
#define BC_TILE 8192    // complex outputs of one GEMM pass: 32 x 32 a warp
#define BC_TMAX 256     // the widest side of a tile
#define BC_OUT 4096     // complex entries of the write-back buffer
#define BC_STAGE 12288  // floats of one staged slab of both operands
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

// The real part of element (h, l) of state pair `pair` (planes 2 pair, 2
// pair + 1; the imaginary part NL floats on), on whichever rank holds it.
__device__ __forceinline__ const float* state_ptr(const Part& q, int pair, int h, int l) {
    const int r = q.part_hi ? (h >> q.lh) : (l >> q.ll);
    const float* e = q.smem + (size_t)(2 * pair) * q.NL + local_idx(q, h, l);
    return r == q.rank ? e : cg::this_cluster().map_shared_rank(e, (unsigned)r);
}

__device__ __forceinline__ void put4(float* d, float a, float b, float c, float e) {
    *reinterpret_cast<float4*>(d) = make_float4(a, b, c, e);
}

// The operands of the tile GEMM are staged as rows p0 .. p0 + ks - 1 of
// the contracted index p, columns w < W of the tile's free index, into
// (dr, di) with row stride W + 8; zero past P or nw. The producer warps
// stage (pt: this thread's index among them); one loader per kind of
// source, each straight-line code.

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// A packed [K][K] re / im matrix pair in device memory: element (p, w) is
// M[p][c0 + w]. Rows stream from L2 by 16-byte cp.async (the caller waits).
struct MatSrc {
    const float* g;
    int K, c0, nw;

    __device__ __forceinline__ void stage(const Part&, int pt, int p0, int P, int ks, int W,
                                          float* dr, float* di) const {
        const int S = W + 8;
        const size_t kk = (size_t)K * K;
        if (K >= 4) {  // aligned runs of 4 columns (nw and c0 are multiples of 4)
            const int wn = W / 4;
            for (int e = pt; e < ks * wn; e += BC_PRODUCERS) {
                const int pp = e / wn, w = 4 * (e - pp * wn);
                float* d = dr + pp * S + w;
                if (p0 + pp < P && w < nw) {
                    const float* src = g + (size_t)(p0 + pp) * K + c0 + w;
                    cp_async16(d, src);
                    cp_async16(di + pp * S + w, src + kk);
                } else {
                    put4(d, 0.f, 0.f, 0.f, 0.f);
                    put4(di + pp * S + w, 0.f, 0.f, 0.f, 0.f);
                }
            }
            return;
        }
        for (int e = pt; e < ks * W; e += BC_PRODUCERS) {
            const int pp = e / W, w = e - pp * W;
            const bool in = p0 + pp < P && w < nw;
            const size_t src = (size_t)(p0 + pp) * K + c0 + w;
            dr[pp * S + w] = in ? __ldg(g + src) : 0.f;
            di[pp * S + w] = in ? __ldg(g + kk + src) : 0.f;
        }
    }
};

// State pair `pair`, held by the cluster: element (p, w) is s(h, l) with
// (h, l) = (p, c0 + w) when p_is_h, else (c0 + w, p); conj negates the
// imaginary part. A slice's rows run along l, so float4 reads run along w
// (p_is_h; four runs a thread in flight) or along p, then as 4 x 4 blocks
// transposed in registers. Blocks or slices narrower than 4 go element by
// element.
struct StateSrc {
    int pair;
    bool p_is_h, conj;
    int c0, nw;

    __device__ __forceinline__ void stage(const Part& q, int pt, int p0, int P, int ks,
                                          int W, float* dr, float* di) const {
        const int S = W + 8, NL = q.NL;
        const float sg = conj ? -1.f : 1.f;
        const bool vec = q.ll >= 2 && (p_is_h ? nw % 4 == 0 : P % 4 == 0);
        if (vec && p_is_h) {
            const int wn = W / 4, n = ks * wn;
            for (int e0 = pt; e0 < n; e0 += 4 * BC_PRODUCERS) {
                float4 v[8];
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const int e = e0 + k * BC_PRODUCERS;
                    const int pp = e / wn, w = 4 * (e - pp * wn);
                    v[2 * k] = v[2 * k + 1] = zero4();
                    if (e < n && p0 + pp < P && w < nw) {
                        const float* src = state_ptr(q, pair, p0 + pp, c0 + w);
                        v[2 * k] = *reinterpret_cast<const float4*>(src);
                        v[2 * k + 1] = *reinterpret_cast<const float4*>(src + NL);
                    }
                }
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const int e = e0 + k * BC_PRODUCERS;
                    const int pp = e / wn, w = 4 * (e - pp * wn);
                    if (e < n) {
                        const float4 a = v[2 * k], b = v[2 * k + 1];
                        put4(dr + pp * S + w, a.x, a.y, a.z, a.w);
                        put4(di + pp * S + w, sg * b.x, sg * b.y, sg * b.z, sg * b.w);
                    }
                }
            }
        } else if (vec) {
            // consecutive threads take consecutive runs of one row
            const int pb = ks / 4;
            for (int e = pt; e < pb * (W / 4); e += BC_PRODUCERS) {
                const int p4 = 4 * (e % pb), w4 = 4 * (e / pb);
                float4 a[4], b[4];
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    a[k] = b[k] = zero4();
                    if (p0 + p4 < P && w4 + k < nw) {
                        const float* src = state_ptr(q, pair, c0 + w4 + k, p0 + p4);
                        a[k] = *reinterpret_cast<const float4*>(src);
                        b[k] = *reinterpret_cast<const float4*>(src + NL);
                    }
                }
                float* d = dr + p4 * S + w4;
                float* f = di + p4 * S + w4;
                put4(d, a[0].x, a[1].x, a[2].x, a[3].x);
                put4(d + S, a[0].y, a[1].y, a[2].y, a[3].y);
                put4(d + 2 * S, a[0].z, a[1].z, a[2].z, a[3].z);
                put4(d + 3 * S, a[0].w, a[1].w, a[2].w, a[3].w);
                put4(f, sg * b[0].x, sg * b[1].x, sg * b[2].x, sg * b[3].x);
                put4(f + S, sg * b[0].y, sg * b[1].y, sg * b[2].y, sg * b[3].y);
                put4(f + 2 * S, sg * b[0].z, sg * b[1].z, sg * b[2].z, sg * b[3].z);
                put4(f + 3 * S, sg * b[0].w, sg * b[1].w, sg * b[2].w, sg * b[3].w);
            }
        } else {
            for (int e = pt; e < ks * W; e += BC_PRODUCERS) {
                const int pp = e / W, w = e - pp * W;
                float a = 0.f, b = 0.f;
                if (p0 + pp < P && w < nw) {
                    const float* src = p_is_h ? state_ptr(q, pair, p0 + pp, c0 + w)
                                              : state_ptr(q, pair, c0 + w, p0 + pp);
                    a = src[0];
                    b = sg * src[NL];
                }
                dr[pp * S + w] = a;
                di[pp * S + w] = b;
            }
        }
    }
};

__device__ __forceinline__ int tile_rows(int X) {
    return X < 32 ? 32 : (X > BC_TMAX ? BC_TMAX : X);
}

// The k-slab depth of a TI x TJ tile: both operands' slabs of one stage
// within BC_STAGE floats, a multiple of the mma's 8 (16 or 24).
__device__ __forceinline__ int slab_depth(int TI, int TJ) {
    return (BC_STAGE / (2 * (TI + TJ + 16))) & ~7;
}

// This consumer warp's 32 x 32 tile of a TI x TJ tile (TJ / 32 warps a
// row).
__device__ __forceinline__ void warp_origin(int TJ, int& m0, int& n0) {
    const int w = threadIdx.x >> 5, wn = TJ / 32;
    m0 = (w / wn) * 32;
    n0 = (w % wn) * 32;
}

// A warp's complex accumulators: [mt][nt][re/im][C fragment element].
typedef float Acc[2][4][2][4];

// acc[mt][nh + nt] += A * B of one k-step, complex, in 3xTF32, for the
// two B fragments nt of half nh (fragments split [re/im][mt or nt][q]).
// The tensor cores round each mma's sum toward zero, a bias that grows
// with every mma into a running sum: at 16 qubits, 6 a k-step over 32
// k-steps a product, then 6 products deep, left the forward's loss 2.2e-5
// off the f32 engine's (the limit is 2e-5). With FLUSH, a k-step's 6 mma
// of each output go into a fresh sum t (4 chains side by side) that joins
// acc by an f32 add, rounded to nearest, so the mma roundings act on one
// k-step's partial sum only (the 16q forward's error fell from 2.6e-7 to
// 1.5e-8; it costs registers and an add a k-step). Without, the 48 mma go
// straight into acc, consecutive ones into different accumulators.
template <bool FLUSH>
__device__ __forceinline__ void cmma_half(Acc acc, int nh, const uint32_t ah[2][2][4],
                                          const uint32_t al[2][2][4],
                                          const uint32_t bh[2][2][2],
                                          const uint32_t bl[2][2][2]) {
    uint32_t nhi[2][2], nlo[2][2];  // -B_im, exactly (the sign bit)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            nhi[nt][e] = bh[1][nt][e] ^ 0x80000000u;
            nlo[nt][e] = bl[1][nt][e] ^ 0x80000000u;
        }
    // the three passes, two small cross terms first, then hi * hi (mma3's
    // order), over rows mt of [m_lo, m_hi) into dst(mt, nt, re/im); in
    // each, re += Ar Br - Ai Bi and im += Ar Bi + Ai Br
    auto passes = [&](int m_lo, int m_hi, auto dst) {
        auto pass = [&](const uint32_t (*a)[2][4], const uint32_t (*br)[2],
                        const uint32_t (*bi)[2], const uint32_t (*bn)[2]) {
#pragma unroll
            for (int mt = m_lo; mt < m_hi; ++mt)
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) mma_tf32(dst(mt, nt, 0), a[0][mt], br[nt]);
#pragma unroll
            for (int mt = m_lo; mt < m_hi; ++mt)
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) mma_tf32(dst(mt, nt, 1), a[0][mt], bi[nt]);
#pragma unroll
            for (int mt = m_lo; mt < m_hi; ++mt)
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) mma_tf32(dst(mt, nt, 0), a[1][mt], bn[nt]);
#pragma unroll
            for (int mt = m_lo; mt < m_hi; ++mt)
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) mma_tf32(dst(mt, nt, 1), a[1][mt], br[nt]);
        };
        pass(al, bh[0], bh[1], nhi);
        pass(ah, bl[0], bl[1], nlo);
        pass(ah, bh[0], bh[1], nhi);
    };
    if constexpr (FLUSH) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
            float t[2][2][4] = {};  // [nt][re/im]
            passes(mt, mt + 1, [&](int, int nt, int c) -> float* { return t[nt][c]; });
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                for (int c = 0; c < 2; ++c)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[mt][nh + nt][c][e] += t[nt][c][e];
        }
    } else {
        passes(0, 2, [&](int mt, int nt, int c) -> float* { return acc[mt][nh + nt][c]; });
    }
}

// acc += the staged slab's ks rows of A(p, i) B(p, j), i from m0, j from
// n0 (row strides SA, SB), a k-step at a time, each fragment split once
// and used for every product it enters (the B fragments two at a time, to
// keep registers for the accumulators). Which tile row or column each
// fragment element stands for is this warp's choice: lane (g, t) takes
// rows m0 + 4 g .. + 3 (mt, row half) and columns n0 + 4 g .. + 3 (nt), so
// that its A elements of a k-row are one float4 and its B elements two
// float2 (each_out maps the results back).
template <bool FLUSH>
__device__ __forceinline__ void mma_slab(const float* __restrict__ ar,
                                         const float* __restrict__ ai, int SA,
                                         const float* __restrict__ br,
                                         const float* __restrict__ bi, int SB, int ks,
                                         int m0, int n0, Acc acc) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const float* pa = ar + t * SA + m0 + 4 * g;
    const float* pb = br + t * SB + n0 + 4 * g;
    const int ia = (int)(ai - ar), ib = (int)(bi - br);
#pragma unroll 1
    for (int kk = 0; kk < ks; kk += 8) {
        uint32_t ah[2][2][4], al[2][2][4];
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)  // k rows t and t + 4
#pragma unroll
            for (int c = 0; c < 2; ++c) {  // re, im
                const float4 v =
                    *reinterpret_cast<const float4*>(pa + (kk + 4 * kh) * SA + c * ia);
                // element q of an A fragment: row half q % 2, k half q / 2
                split_tf32(v.x, ah[c][0][2 * kh], al[c][0][2 * kh]);
                split_tf32(v.y, ah[c][0][2 * kh + 1], al[c][0][2 * kh + 1]);
                split_tf32(v.z, ah[c][1][2 * kh], al[c][1][2 * kh]);
                split_tf32(v.w, ah[c][1][2 * kh + 1], al[c][1][2 * kh + 1]);
            }
#pragma unroll
        for (int nh = 0; nh < 4; nh += 2) {
            uint32_t bh[2][2][2], bl[2][2][2];
#pragma unroll
            for (int kh = 0; kh < 2; ++kh)
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    const float2 u = *reinterpret_cast<const float2*>(
                        pb + (kk + 4 * kh) * SB + c * ib + nh);
                    split_tf32(u.x, bh[c][0][kh], bl[c][0][kh]);
                    split_tf32(u.y, bh[c][1][kh], bl[c][1][kh]);
                }
            cmma_half<FLUSH>(acc, nh, ah, al, bh, bl);
        }
    }
}

// Named barriers between the producer and the consumer warps, one pair a
// staged slab buffer b: FULL + b (the producers filled b) and EMPTY + b
// (the consumers are done with it); barrier 0 is __syncthreads.
#define BAR_FULL 1
#define BAR_EMPTY 3

__device__ __forceinline__ void bar_sync(int id) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(BC_THREADS) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
    asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(BC_THREADS) : "memory");
}

__device__ __forceinline__ bool consumer() { return threadIdx.x < BC_CONSUMERS; }

// acc(i, j) = sum_{p < P} A(p, i) B(p, j) over one TI x TJ tile (TI * TJ =
// BC_TILE, TI in [32, BC_TMAX]), each consumer warp's 32 x 32 part at
// warp_origin; valid i < ni, j < nj (a warp wholly in the padding skips
// its products). The producer warps stage slab s + 1 into one of two
// BC_STAGE buffers (one, where !two_stages) while the consumers compute
// slab s from the other. Run by every thread of the CTA; ends in a CTA
// barrier.
template <bool FLUSH, class SrcA, class SrcB>
__device__ __forceinline__ void tile_mma(const SrcA& a, const SrcB& b, const Part& q,
                                         int P, int TI, int TJ, int ni, int nj,
                                         float* stage, bool two_stages, Acc acc) {
    const int ks = slab_depth(TI, TJ);
    const int SA = TI + 8, SB = TJ + 8;
    const int slabs = (P + ks - 1) / ks, nb = two_stages ? 2 : 1;
    if (consumer()) {
        int m0, n0;
        warp_origin(TJ, m0, n0);
        const bool active = m0 < ni && n0 < nj;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int e = 0; e < 8; ++e) acc[mt][nt][e / 4][e % 4] = 0.f;
        for (int s = 0; s < slabs; ++s) {
            const int u = s % nb;
            const float* ar = stage + u * BC_STAGE;
            const float* br = ar + 2 * ks * SA;
            bar_sync(BAR_FULL + u);
            if (active)
                mma_slab<FLUSH>(ar, ar + ks * SA, SA, br, br + ks * SB, SB, ks, m0, n0, acc);
            if (s + nb < slabs) bar_arrive(BAR_EMPTY + u);
        }
    } else {
        const int pt = threadIdx.x - BC_CONSUMERS;
        for (int s = 0; s < slabs; ++s) {
            const int u = s % nb;
            float* ar = stage + u * BC_STAGE;
            float* br = ar + 2 * ks * SA;
            if (s >= nb) bar_sync(BAR_EMPTY + u);
            a.stage(q, pt, s * ks, P, ks, TI, ar, ar + ks * SA);
            b.stage(q, pt, s * ks, P, ks, TJ, br, br + ks * SB);
            cp_async_commit();
            cp_async_wait<0>();
            bar_arrive(BAR_FULL + u);
        }
    }
    __syncthreads();
}

// Call fn(i, j, re, im) for each valid output of this warp's tile: C row
// g + 8 h of fragment mt is tile row m0 + 4 g + 2 mt + h, and C column n of
// fragment nt tile column n0 + 4 n + nt (mma_slab's choice).
template <class Fn>
__device__ __forceinline__ void each_out(const Acc acc, int TJ, int ni, int nj, Fn fn) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    int m0, n0;
    warp_origin(TJ, m0, n0);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int i = m0 + 4 * g + 2 * mt + (e >> 1);
                const int j = n0 + 4 * (2 * t + (e & 1)) + nt;
                if (i < ni && j < nj) fn(i, j, acc[mt][nt][0][e], acc[mt][nt][1][e]);
            }
}

// slab[(i0 + i) K + j0 + j] += this warp's outputs (re K * K floats, then
// im), a float4 at a time: a thread's columns n0 + 4 n .. + 3 (nt).
__device__ __forceinline__ void add_tile(float* slab, int K, int i0, int j0, const Acc acc,
                                         int TJ, int ni, int nj) {
    if (nj % 4) {
        each_out(acc, TJ, ni, nj, [&](int i, int j, float re, float im) {
            const size_t e = (size_t)(i0 + i) * K + j0 + j;
            slab[e] += re;
            slab[(size_t)K * K + e] += im;
        });
        return;
    }
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    int m0, n0;
    warp_origin(TJ, m0, n0);
    const size_t kk = (size_t)K * K;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // row half e / 2, column pair e % 2
            const int i = m0 + 4 * g + 2 * mt + (e >> 1), j = n0 + 4 * (2 * t + (e & 1));
            if (i < ni && j < nj) {
                float* d = slab + (size_t)(i0 + i) * K + j0 + j;
                float4 r = *reinterpret_cast<float4*>(d);
                float4 m = *reinterpret_cast<float4*>(d + kk);
                r.x += acc[mt][0][0][e];
                r.y += acc[mt][1][0][e];
                r.z += acc[mt][2][0][e];
                r.w += acc[mt][3][0][e];
                m.x += acc[mt][0][1][e];
                m.y += acc[mt][1][1][e];
                m.z += acc[mt][2][1][e];
                m.w += acc[mt][3][1][e];
                *reinterpret_cast<float4*>(d) = r;
                *reinterpret_cast<float4*>(d + kk) = m;
            }
        }
}

// State pair `pair` <- contract(pair, M) along the hi or lo axis, in place;
// M is a packed [K][K] re / im pair in device memory. `stage` holds two
// slabs of BC_STAGE floats; the write-back buffer (2 * BC_OUT floats)
// shares the second where a rank's x range is wider than a tile.
template <bool FLUSH>
__device__ void mat_step(const Part& q, int pair, bool hi, const float* M, float* stage) {
    const int kb = hi ? q.hb : q.lb;
    const int K = 1 << kb, Q = 1 << (q.n - kb);
    const bool cross = q.C > 1 && hi == (q.part_hi != 0);
    const bool split_y = q.C > 1 && !cross;
    const int Xn = cross ? K / q.C : K;
    const int x0 = cross ? q.rank * Xn : 0;
    const int Yn = split_y ? Q / q.C : Q;
    const int y0 = split_y ? q.rank * Yn : 0;
    const int TI = tile_rows(Xn), TJ = BC_TILE / TI;
    // a chunk of F fibers is one tile, or, where Xn > TI, Xn / TI tiles
    // whose outputs wait in the write-back buffer (Xn <= BC_OUT:
    // cluster_config)
    const bool wide = Xn > TI;
    const int F = min(Yn, wide ? BC_OUT / Xn : TJ);
    float* outr = stage + BC_STAGE;
    float* outi = outr + BC_OUT;
    float* sr = q.smem + (size_t)(2 * pair) * q.NL;
    float* si = sr + q.NL;
    for (int yc = y0; yc < y0 + Yn; yc += F) {
        Acc acc;
        for (int i0 = 0; i0 < Xn; i0 += TI) {
            const int ni = min(TI, Xn - i0);
            tile_mma<FLUSH>(MatSrc{M, K, x0 + i0, ni}, StateSrc{pair, hi, false, yc, F}, q,
                            K, TI, TJ, ni, F, stage, !wide, acc);
            if (wide && consumer())
                each_out(acc, TJ, ni, F, [&](int i, int j, float re, float im) {
                    // the order the write-back walks the state in
                    const int o = hi ? (i0 + i) * F + j : j * Xn + i0 + i;
                    outr[o] = re;
                    outi[o] = im;
                });
        }
        // every reader of the chunk's inputs (the cluster where cross) is done
        sync_part(cross);
        if (wide) {
            for (int e = threadIdx.x; e < Xn * F; e += BC_THREADS) {
                const int i = hi ? e / F : e % Xn;
                const int j = hi ? e % F : e / Xn;
                const int x = x0 + i, y = yc + j;
                const int idx = hi ? local_idx(q, x, y) : local_idx(q, y, x);
                sr[idx] = outr[e];
                si[idx] = outi[e];
            }
            __syncthreads();
        } else if (consumer()) {
            // the producers meanwhile stage the next chunk's first slab
            each_out(acc, TJ, Xn, F, [&](int i, int j, float re, float im) {
                const int x = x0 + i, y = yc + j;
                const int idx = hi ? local_idx(q, x, y) : local_idx(q, y, x);
                sr[idx] = re;
                si[idx] = im;
            });
        }
    }
}

// slab[k][m] (re K*K floats, then im) += sum_y conj s(k, y) g(m, y) for
// this sample, s state pair 0 and g pair 1; the K x K tiles go round the
// ranks, so each entry has one writer.
template <bool FLUSH>
__device__ void dm_step(const Part& q, bool hi, float* slab, float* stage) {
    const int kb = hi ? q.hb : q.lb;
    const int K = 1 << kb, Q = 1 << (q.n - kb);
    const int TI = K >= 64 ? 64 : 32, TJ = BC_TILE / TI;
    const int nti = (K + TI - 1) / TI, ntj = (K + TJ - 1) / TJ;
    for (int t = q.rank; t < nti * ntj; t += q.C) {
        const int i0 = (t / ntj) * TI, j0 = (t % ntj) * TJ;
        const int ni = min(TI, K - i0), nj = min(TJ, K - j0);
        Acc acc;
        // the contracted index is y: along h where the step is on lo
        tile_mma<FLUSH>(StateSrc{0, !hi, true, i0, ni}, StateSrc{1, !hi, false, j0, nj}, q,
                        Q, TI, TJ, ni, nj, stage, true, acc);
        if (consumer()) add_tile(slab, K, i0, j0, acc, TJ, ni, nj);
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
    float* stage = smem + 2 * (size_t)q.NL;
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
                // FLUSH: the loss a forward feeds is held to 2e-5 relative
                mat_step<true>(q, 0, plan.axis[st] == 0, mats + plan.off[st], stage);
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
    // planes: s re, s im, g re, g im; then the GEMM's two staged slabs
    extern __shared__ __align__(16) float smem[];
    const Part q = make_part(smem, hb, lb, part_hi);
    float* stage = smem + 4 * (size_t)q.NL;
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
                // no FLUSH: measured at 16 qubits on an H100, the grads of
                // a stage-2 step stay within 1.1e-5 of scale (limit 2e-4)
                // without it, and with it the backward took 139 ms at
                // B = 1536 instead of 113
                mat_step<false>(q, 0, hi, mct, stage);  // input recovery
                sync_part(multi);
                dm_step<false>(q, hi, part + plan.off[st], stage);
                sync_part(multi);
                mat_step<false>(q, 1, hi, mct, stage);  // cotangent pullback
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

// Shared floats of one CTA: its state planes and the GEMM's two staged
// slabs, the second shared with the write-back buffer (cluster_config in
// ops/block_kernel.py mirrors this).
static size_t bc_floats(int planes, int NL) {
    return (size_t)planes * NL + 2 * BC_STAGE;
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
    // the matrix rows stream by 16-byte cp.async
    if ((uintptr_t)mats % 16) return (int)cudaErrorMisalignedAddress;
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
    if ((uintptr_t)matcts % 16) return (int)cudaErrorMisalignedAddress;
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
