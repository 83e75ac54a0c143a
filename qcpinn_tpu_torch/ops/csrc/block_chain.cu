// Block-chain evolution kernels for Hopper (sm_90a).
//
// Replaces qcpinn_tpu/ops/block_pallas.py::_forward_kernel (K1) and
// ::_backward_kernel (K2). The state of one sample is s[H][L] in split
// re/im f32. A plan is a table of steps:
//   mat  : contract one axis with a shared complex [K, K] matrix M[in, out]
//          (axis hi: s[m][l] = sum_k M[k][m] s[k][l]; lo: s[h][m] = sum_k
//          s[h][k] M[k][m]);
//   diag : multiply by the phase planes (cos + i sin)[H][L].
//
// What bounds them: at 12 qubits (H = L = K = 64) each mat step is a
// 64x64x64 complex product per sample, so the chain does ~21 FMA per byte
// of state it reads: arithmetic, not device memory, is the limit. Both
// kernels keep every sample's state in shared memory for the whole chain
// (one read and one write of device memory), and both run their products
// on the tensor cores in 3xTF32: each f32 operand splits into a TF32 high
// part and a TF32 low part of the remainder, and hi*hi + hi*lo + lo*hi
// accumulate in f32 (mma.sync m16n8k8; tf32_mma.cuh, shared with the
// cluster pair), which keeps the f32 parity the port is held to (a single
// TF32 pass would not). The one product routine, contract_tile, serves
// K1's mat steps and K2's recoveries and pullbacks alike. What is left
// around the products is splitting operands, feeding them from shared
// memory and waiting on barriers; the designs below cut each of those.
//
// K1, the forward, runs on a persistent grid of one CTA per SM; a CTA
// sweeps a tile of T samples through the plan together (the caller picks
// T for the batch, so that the last round of tiles leaves few SMs idle:
// fwd_config in ops/block_kernel.py),
// so each k-step's fragment of a matrix is split once for T samples. The
// next mat step's matrix streams into a second shared buffer (cp.async)
// while the current step computes, and a diag step that follows a mat
// step is applied to that product's sums before they are stored, which
// saves a pass over shared memory and a barrier. The tensor cores round
// each mma's sum toward zero; K1 adds each k-step's partial sums into its
// accumulators in f32 (mma_step's FLUSH), which keeps that bias off the
// loss (with running sums the 12q train step's loss sat at half its 2e-5
// limit).
//
// K2, the reverse sweep, runs its three products per mat step (recover the
// step's input, form the matrix cotangent, pull the cotangent back) on the
// tensor cores as K1 does. It sweeps the plan in
// reverse from the final state with O(1) state memory: the matrices
// arrive conj-transposed (Mct = conj(M)^T), and one contraction with Mct
// both recovers the step's input and pulls the cotangent back. A CTA takes
// a tile of samples through the sweep together; each warp sums its part of
// a mat's cotangent over the tile in registers and adds it to the CTA's
// slab once a tile, and the phase cotangents likewise, so the slabs (one
// per CTA, one CTA per SM: 33 MB at 12 qubits) stay in L2. The next mat
// step's Mct streams into a second shared buffer (cp.async) while the
// current step computes. In both kernels the state rows are unpadded and
// XOR-swizzled (sidx below), so that the fragment loads of every product,
// in either orientation, hit distinct banks.
//
// The matrix and phase cotangents are sums over the batch. A TPU grid runs
// in order and can carry that sum across grid steps; CTAs cannot, so a
// persistent grid of G CTAs each sums its own samples into a private slab
// in device memory, and a second kernel adds the G slabs in a fixed order
// (slab_sum.cuh, shared with the other backwards).
// No float atomics: the result is deterministic.
//
// Plain C interface (loaded with ctypes); every entry returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "slab_sum.cuh"
#include "tf32_mma.cuh"

#define QC_MAX_STEPS 128
#define QC_THREADS 256
#define QC_WARPS (QC_THREADS / 32)
#define QC_TILE 2      // most samples a backward CTA sweeps together (bwd_config)
#define QC_FWD_TILE 4  // most samples a forward CTA sweeps together (K1's register tile)
#define QC_SMEM_MAX 232448  // a CTA's opt-in shared memory on sm_90 (227 KiB)

struct QcPlan {
    int n_steps;
    int kind[QC_MAX_STEPS];  // 0 = mat, 1 = diag
    int axis[QC_MAX_STEPS];  // 0 = hi, 1 = lo (mat only)
    int off[QC_MAX_STEPS];   // float offset into the packed mats / phases
    // the mat step the backward's sweep reaches after this one (wrapping
    // to the sweep's first mat step), or -1 where the plan has no mat
    int next_mat[QC_MAX_STEPS];
    int first_mat;  // the sweep's first mat step (the plan's last), or -1
    // the same for the forward's sweep, which runs the plan in order: the
    // next mat step after this one (wrapping to the plan's first), or -1
    int fwd_next_mat[QC_MAX_STEPS];
    int fwd_first_mat;
};

// -- shared helpers of both kernels ----------------------------------------
//
// Shared arrays are [rows][W] with W a power of two >= 32, unpadded, each
// row's columns XOR-permuted by a multiple of 4 (sidx). A warp's mma
// fragment loads read either 8 rows x 4 columns or 4 rows x 8 columns (by
// the product's orientation); the swizzle sends both to 32 distinct banks,
// and it keeps aligned runs of 4 columns contiguous (float4 and 16-byte
// cp.async stay whole).
__device__ __forceinline__ int swz(int r) {
    return ((r & 3) << 3) | (((r >> 2) & 1) << 2);
}

__device__ __forceinline__ int sidx(int r, int c, int W) {
    return r * W + (c ^ swz(r));
}

// The products below step through the contracted index p = p1 + kk + r
// (p1 a multiple of 32, kk a multiple of 8 below 32, r < 8), so that the
// swizzle of a fragment element (it touches bits 2..4 of a column only)
// is an XOR of kk with a loop-invariant row or column. The k-steps stay
// rolled (unroll 1): unrolling them four times raised the backward to 211
// registers and made it 25% slower than rolled (167). Fragments follow
// mma.m16n8k8's layout (tf32_mma.cuh).

// One k-step's A fragment of a warp's 32-row tile at m0, columns p1 + kk
// .. + 7 (p1 a multiple of 32), split into TF32 hi / lo: [re/im][mt][q].
// A(i, p) is the swizzled element (i, p) of (ar, ai) with row length w, or
// (p, i) when A_T; CONJ negates the imaginary part.
template <bool A_T, bool CONJ>
__device__ __forceinline__ void frag_a(const float* __restrict__ ar,
                                       const float* __restrict__ ai, int w, int m0,
                                       int p1, int kk, uint32_t h[2][2][4],
                                       uint32_t l[2][2][4]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int i = m0 + mt * 16 + g + 8 * (q & 1);
            const int c = kk + 4 * (q >> 1);  // p = p1 + c + t
            const int idx = A_T ? (p1 + c + t) * w + (i ^ ((t << 3) | (c & 4)))
                                : i * w + p1 + ((c ^ swz(i)) | t);
            split_tf32(ar[idx], h[0][mt][q], l[0][mt][q]);
            split_tf32(CONJ ? -ai[idx] : ai[idx], h[1][mt][q], l[1][mt][q]);
        }
}

// One k-step's B fragment of a warp's 16-column tile at n0, rows p1 + kk ..
// + 7: [re/im][nt][q]. B(p, j) is element (p, j) of (br, bi), or (j, p)
// when B_T.
template <bool B_T>
__device__ __forceinline__ void frag_b(const float* __restrict__ br,
                                       const float* __restrict__ bi, int w, int n0,
                                       int p1, int kk, uint32_t h[2][2][2],
                                       uint32_t l[2][2][2]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const int j = n0 + nt * 8 + g;
            const int c = kk + 4 * q;  // p = p1 + c + t
            const int idx = B_T ? j * w + p1 + ((c ^ swz(j)) | t)
                                : (p1 + c + t) * w + (j ^ ((t << 3) | (c & 4)));
            split_tf32(br[idx], h[0][nt][q], l[0][nt][q]);
            split_tf32(bi[idx], h[1][nt][q], l[1][nt][q]);
        }
}

// One warp's 32x16 complex tile at (m0, n0): acc[mt][nt][re/im][4] +=
// sum_{p < P} opA(A)(m, p) * B(p, n) (frag_a, frag_b); P a multiple of 32.
template <bool A_T, bool B_T, bool CONJ_A>
__device__ __forceinline__ void cgemm_warp(
    const float* __restrict__ ar, const float* __restrict__ ai, int aw,
    const float* __restrict__ br, const float* __restrict__ bi, int bw, int P,
    int m0, int n0, float acc[2][2][2][4]) {
    for (int p1 = 0; p1 < P; p1 += 32) {
#pragma unroll 1
        for (int kk = 0; kk < 32; kk += 8) {
            uint32_t ah[2][2][4], al[2][2][4], bh[2][2][2], bl[2][2][2];
            frag_a<A_T, CONJ_A>(ar, ai, aw, m0, p1, kk, ah, al);
            frag_b<B_T>(br, bi, bw, n0, p1, kk, bh, bl);
            mma_step<false>(acc, ah, al, bh, bl);
        }
    }
}

// Write a warp's tile at (m0, n0) into swizzled (outr, outi), row length W.
__device__ __forceinline__ void store_tile(float* outr, float* outi, int W,
                                           int m0, int n0,
                                           const float acc[2][2][2][4]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int idx = sidx(m0 + mt * 16 + g + 8 * h, n0 + nt * 8 + 2 * t, W);
                *reinterpret_cast<float2*>(outr + idx) =
                    make_float2(acc[mt][nt][0][2 * h], acc[mt][nt][0][2 * h + 1]);
                *reinterpret_cast<float2*>(outi + idx) =
                    make_float2(acc[mt][nt][1][2 * h], acc[mt][nt][1][2 * h + 1]);
            }
}

// Add a warp's tile at (m0, n0) into a [K][K] re / im pair in device memory.
__device__ __forceinline__ void add_tile(float* pr, float* pi, int K, int m0,
                                         int n0, const float acc[2][2][2][4]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int e = (m0 + mt * 16 + g + 8 * h) * K + n0 + nt * 8 + 2 * t;
                float2 r = *reinterpret_cast<float2*>(pr + e);
                float2 i = *reinterpret_cast<float2*>(pi + e);
                r.x += acc[mt][nt][0][2 * h];
                r.y += acc[mt][nt][0][2 * h + 1];
                i.x += acc[mt][nt][1][2 * h];
                i.y += acc[mt][nt][1][2 * h + 1];
                *reinterpret_cast<float2*>(pr + e) = r;
                *reinterpret_cast<float2*>(pi + e) = i;
            }
}

// Start copying a packed [K][K] re / im pair into swizzled shared rows.
__device__ __forceinline__ void load_mat_async(const float* __restrict__ g, int K,
                                               float* mr, float* mi) {
    const int chunks = K * K / 4;
    for (int c = threadIdx.x; c < 2 * chunks; c += QC_THREADS) {
        const int plane = c >= chunks;
        const int e = 4 * (c - plane * chunks);
        const int r = e / K;
        cp_async16((plane ? mi : mr) + sidx(r, e - r * K, K), g + plane * K * K + e);
    }
}

// s <- contract(s, M) on the step's axis, in place, for the nt <= TM
// samples of a tile, sample k's re / im planes of H x L at smem + (stride
// k + plane) H L and H L further. K1's mat steps pass M; K2's recovery and
// pullback pass Mct. The H x L output is H*L/512 <= 8 warp tiles, one per
// warp; each k-step's fragment of the matrix is split once and serves
// every sample of the tile. With PHASE the product's sums are multiplied
// by the phase planes (cos, sin)[H][L] at pc before they are stored: a
// diag step that follows the mat step, folded in. FLUSH adds each k-step's
// partial sums into the accumulators in f32 (mma_step): K1 takes it, K2
// keeps its running sums.
template <bool HI, int TM, bool PHASE, bool FLUSH>
__device__ __forceinline__ void contract_tile(float* smem, int stride, int plane,
                                              int nt, const float* mr,
                                              const float* mi, int H, int L,
                                              const float* __restrict__ pc) {
    const int HL = H * L;
    const int warp = threadIdx.x >> 5;
    const bool active = warp < HL / 512;
    const int m0 = (warp / (L / 16)) * 32, n0 = (warp % (L / 16)) * 16;
    float acc[TM][2][2][2][4];
#pragma unroll
    for (int k = 0; k < TM; ++k) zero_acc(acc[k]);
    if (active) {
        for (int p1 = 0; p1 < (HI ? H : L); p1 += 32) {
#pragma unroll 1
            for (int kk = 0; kk < 32; kk += 8) {
                uint32_t ah[2][2][4], al[2][2][4], bh[2][2][2], bl[2][2][2];
                if (HI)  // x'[m][l] = sum_k M[k][m] x[k][l]
                    frag_a<true, false>(mr, mi, H, m0, p1, kk, ah, al);
                else  // x'[h][m] = sum_k x[h][k] M[k][m]
                    frag_b<false>(mr, mi, L, n0, p1, kk, bh, bl);
#pragma unroll
                for (int k = 0; k < TM; ++k) {
                    if (k >= nt) break;
                    const float* xr = smem + (size_t)(stride * k + plane) * HL;
                    if (HI)
                        frag_b<false>(xr, xr + HL, L, n0, p1, kk, bh, bl);
                    else
                        frag_a<false, false>(xr, xr + HL, L, m0, p1, kk, ah, al);
                    mma_step<FLUSH>(acc[k], ah, al, bh, bl);
                }
            }
        }
        if (PHASE) {  // (re + i im) (c + i s); one phase serves every sample
            const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int ntl = 0; ntl < 2; ++ntl)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int e = (m0 + mt * 16 + g + 8 * h) * L + n0 + ntl * 8 + 2 * t;
                        const float2 c = *reinterpret_cast<const float2*>(pc + e);
                        const float2 s = *reinterpret_cast<const float2*>(pc + HL + e);
#pragma unroll
                        for (int k = 0; k < TM; ++k)
#pragma unroll
                            for (int j = 0; j < 2; ++j) {
                                float* re = &acc[k][mt][ntl][0][2 * h + j];
                                float* im = &acc[k][mt][ntl][1][2 * h + j];
                                const float cj = j ? c.y : c.x, sj = j ? s.y : s.x;
                                const float a = *re, d = *im;
                                *re = a * cj - d * sj;
                                *im = a * sj + d * cj;
                            }
                    }
        }
    }
    __syncthreads();
    if (active)
#pragma unroll
        for (int k = 0; k < TM; ++k) {
            if (k >= nt) break;
            float* xr = smem + (size_t)(stride * k + plane) * HL;
            store_tile(xr, xr + HL, L, m0, n0, acc[k]);
        }
    __syncthreads();
}

// -- K1: the forward on tensor cores ---------------------------------------

// A diag step on its own (one that no mat step precedes): every sample of
// the tile times the phase planes (cos, sin)[H][L] at pc.
__device__ __forceinline__ void diag_tile(float* smem, int nt,
                                          const float* __restrict__ pc, int H,
                                          int L) {
    const int HL = H * L;
    for (int e = threadIdx.x; e < HL; e += QC_THREADS) {
        const int h = e / L, idx = sidx(h, e - h * L, L);
        const float c = pc[e], s = pc[HL + e];
        for (int k = 0; k < nt; ++k) {
            float* sr = smem + (size_t)2 * k * HL;
            float* si = sr + HL;
            const float a = sr[idx], d = si[idx];
            sr[idx] = a * c - d * s;
            si[idx] = a * s + d * c;
        }
    }
    __syncthreads();
}

extern "C" __global__ void __launch_bounds__(QC_THREADS, 1)
block_chain_fwd_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                       const float* __restrict__ mats,
                       const float* __restrict__ phases, float* __restrict__ yr,
                       float* __restrict__ yi, int B, int H, int L, int T, int NB,
                       QcPlan plan) {
    // shared: T samples of [s_re, s_im] planes of H x L, then NB matrix
    // buffers of [re, im] planes of KM x KM
    extern __shared__ __align__(16) float smem[];
    const int HL = H * L;
    const int KM = H > L ? H : L;
    float* mbuf = smem + (size_t)2 * T * HL;
    const int tid = threadIdx.x;
    int cur = 0;  // the matrix buffer of the current mat step
    if (NB == 2 && plan.fwd_first_mat >= 0) {
        const int f = plan.fwd_first_mat;
        load_mat_async(mats + plan.off[f], plan.axis[f] == 0 ? H : L, mbuf,
                       mbuf + KM * KM);
        cp_async_commit();
    }
    const int tiles = (B + T - 1) / T;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int b0 = tile * T;
        const int nt = min(T, B - b0);
        for (int k = 0; k < nt; ++k) {
            const size_t base = (size_t)(b0 + k) * HL;
            float* dst = smem + (size_t)2 * k * HL;
            for (int e = 4 * tid; e < HL; e += 4 * QC_THREADS) {
                const int h = e / L, idx = sidx(h, e - h * L, L);
                *reinterpret_cast<float4*>(dst + idx) =
                    *reinterpret_cast<const float4*>(xr + base + e);
                *reinterpret_cast<float4*>(dst + HL + idx) =
                    *reinterpret_cast<const float4*>(xi + base + e);
            }
        }
        __syncthreads();
        for (int st = 0; st < plan.n_steps; ++st) {
            if (plan.kind[st] == 1) {
                diag_tile(smem, nt, phases + plan.off[st], H, L);
                continue;
            }
            const bool hi = plan.axis[st] == 0;
            float* mr = mbuf + (size_t)cur * 2 * KM * KM;
            float* mi = mr + KM * KM;
            if (NB == 2) {  // stream the next mat step's matrix meanwhile
                const int nx = plan.fwd_next_mat[st];
                float* nr = mbuf + (size_t)(cur ^ 1) * 2 * KM * KM;
                load_mat_async(mats + plan.off[nx], plan.axis[nx] == 0 ? H : L, nr,
                               nr + KM * KM);
                cp_async_commit();
                cp_async_wait<1>();
            } else {
                load_mat_async(mats + plan.off[st], hi ? H : L, mr, mi);
                cp_async_commit();
                cp_async_wait<0>();
            }
            __syncthreads();
            // a diag step right after this one is applied before the store
            const bool fold = st + 1 < plan.n_steps && plan.kind[st + 1] == 1;
            const float* pc = fold ? phases + plan.off[st + 1] : nullptr;
            if (hi && fold)
                contract_tile<true, QC_FWD_TILE, true, true>(smem, 2, 0, nt, mr, mi,
                                                             H, L, pc);
            else if (hi)
                contract_tile<true, QC_FWD_TILE, false, true>(smem, 2, 0, nt, mr, mi,
                                                              H, L, pc);
            else if (fold)
                contract_tile<false, QC_FWD_TILE, true, true>(smem, 2, 0, nt, mr, mi,
                                                              H, L, pc);
            else
                contract_tile<false, QC_FWD_TILE, false, true>(smem, 2, 0, nt, mr, mi,
                                                               H, L, pc);
            if (fold) ++st;
            if (NB == 2) cur ^= 1;
        }
        for (int k = 0; k < nt; ++k) {
            const size_t base = (size_t)(b0 + k) * HL;
            const float* src = smem + (size_t)2 * k * HL;
            for (int e = 4 * tid; e < HL; e += 4 * QC_THREADS) {
                const int h = e / L, idx = sidx(h, e - h * L, L);
                *reinterpret_cast<float4*>(yr + base + e) =
                    *reinterpret_cast<const float4*>(src + idx);
                *reinterpret_cast<float4*>(yi + base + e) =
                    *reinterpret_cast<const float4*>(src + HL + idx);
            }
        }
        __syncthreads();
    }
    cp_async_wait<0>();
}

// -- K2: the reverse sweep on tensor cores ---------------------------------

extern "C" __global__ void __launch_bounds__(QC_THREADS, 1)
block_chain_bwd_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
                       const float* __restrict__ gr, const float* __restrict__ gi,
                       const float* __restrict__ matcts,
                       const float* __restrict__ phases, float* __restrict__ gxr,
                       float* __restrict__ gxi, float* __restrict__ partials,
                       int slab, int mats_total, int B, int H, int L, int T,
                       int NB, QcPlan plan) {
    // shared: T samples of [s_re, s_im, g_re, g_im] planes of H x L, then NB
    // Mct buffers of [re, im] planes of KM x KM
    extern __shared__ __align__(16) float smem[];
    const int HL = H * L;
    const int KM = H > L ? H : L;
    float* mats = smem + (size_t)4 * T * HL;
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    float* part = partials + (size_t)blockIdx.x * slab;
    for (int e = tid; e < slab; e += QC_THREADS) part[e] = 0.f;
    int cur = 0;  // the Mct buffer of the current mat step
    if (NB == 2 && plan.first_mat >= 0) {
        const int f = plan.first_mat;
        load_mat_async(matcts + plan.off[f], plan.axis[f] == 0 ? H : L, mats,
                       mats + KM * KM);
        cp_async_commit();
    }
    __syncthreads();
    const int tiles = (B + T - 1) / T;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int b0 = tile * T;
        const int nt = min(T, B - b0);
        for (int k = 0; k < nt; ++k) {
            const size_t base = (size_t)(b0 + k) * HL;
            float* dst = smem + (size_t)4 * k * HL;
            for (int e = 4 * tid; e < HL; e += 4 * QC_THREADS) {
                const int h = e / L, idx = sidx(h, e - h * L, L);
                *reinterpret_cast<float4*>(dst + idx) =
                    *reinterpret_cast<const float4*>(yr + base + e);
                *reinterpret_cast<float4*>(dst + HL + idx) =
                    *reinterpret_cast<const float4*>(yi + base + e);
                *reinterpret_cast<float4*>(dst + 2 * HL + idx) =
                    *reinterpret_cast<const float4*>(gr + base + e);
                *reinterpret_cast<float4*>(dst + 3 * HL + idx) =
                    *reinterpret_cast<const float4*>(gi + base + e);
            }
        }
        __syncthreads();
        for (int st = plan.n_steps - 1; st >= 0; --st) {
            if (plan.kind[st] == 0) {
                const bool hi = plan.axis[st] == 0;
                const int K = hi ? H : L;
                float* mr = mats + (size_t)cur * 2 * KM * KM;
                float* mi = mr + KM * KM;
                if (NB == 2) {  // stream the next mat step's Mct meanwhile
                    const int nx = plan.next_mat[st];
                    float* nr = mats + (size_t)(cur ^ 1) * 2 * KM * KM;
                    load_mat_async(matcts + plan.off[nx], plan.axis[nx] == 0 ? H : L,
                                   nr, nr + KM * KM);
                    cp_async_commit();
                    cp_async_wait<1>();
                } else {
                    load_mat_async(matcts + plan.off[st], K, mr, mi);
                    cp_async_commit();
                    cp_async_wait<0>();
                }
                __syncthreads();
                // input recovery: s_in = contract(s_out, Mct)
                if (hi)
                    contract_tile<true, QC_TILE, false, false>(smem, 4, 0, nt, mr, mi,
                                                               H, L, nullptr);
                else
                    contract_tile<false, QC_TILE, false, false>(smem, 4, 0, nt, mr, mi,
                                                                H, L, nullptr);
                // dM = sum over the tile and the other axis of conj(s_in) g:
                // (K / 32) x (K / 16) warp tiles, each summed over the tile
                // in registers, then added to the slab
                float* pr = part + plan.off[st];
                float* pi = pr + K * K;
                const int wt_n = K / 16;
                for (int w = warp; w < (K / 32) * wt_n; w += QC_WARPS) {
                    const int m0 = (w / wt_n) * 32, n0 = (w % wt_n) * 16;
                    float acc[2][2][2][4];
                    zero_acc(acc);
                    for (int k = 0; k < nt; ++k) {
                        const float* sr = smem + (size_t)4 * k * HL;
                        const float* si = sr + HL;
                        const float* qr = si + HL;
                        const float* qi = qr + HL;
                        if (hi)  // dM[k][m] = sum_l conj(s[k][l]) g[m][l]
                            cgemm_warp<false, true, true>(sr, si, L, qr, qi, L, L, m0,
                                                          n0, acc);
                        else  // dM[k][m] = sum_h conj(s[h][k]) g[h][m]
                            cgemm_warp<true, false, true>(sr, si, L, qr, qi, L, H, m0,
                                                          n0, acc);
                    }
                    add_tile(pr, pi, K, m0, n0, acc);
                }
                // cotangent pullback with the same conj-transposed matrix
                if (hi)
                    contract_tile<true, QC_TILE, false, false>(smem, 4, 2, nt, mr, mi,
                                                               H, L, nullptr);
                else
                    contract_tile<false, QC_TILE, false, false>(smem, 4, 2, nt, mr, mi,
                                                                H, L, nullptr);
                if (NB == 2) cur ^= 1;
            } else {
                const float* pc = phases + plan.off[st];
                const float* ps = pc + HL;
                float* gc = part + mats_total + plan.off[st];
                float* gs = gc + HL;
                for (int e = tid; e < HL; e += QC_THREADS) {
                    const int h = e / L, idx = sidx(h, e - h * L, L);
                    const float c = pc[e], s = ps[e];
                    float ac = 0.f, as = 0.f;
                    for (int k = 0; k < nt; ++k) {
                        float* sr = smem + (size_t)4 * k * HL;
                        float* si = sr + HL;
                        float* qr = si + HL;
                        float* qi = qr + HL;
                        // input recovery: conjugate phase
                        const float a = c * sr[idx] + s * si[idx];
                        const float d = c * si[idx] - s * sr[idx];
                        sr[idx] = a;
                        si[idx] = d;
                        const float u = qr[idx], v = qi[idx];
                        // phase cotangents (out = (c + i s) * in)
                        ac += u * a + v * d;
                        as += -u * d + v * a;
                        qr[idx] = c * u + s * v;
                        qi[idx] = c * v - s * u;
                    }
                    gc[e] += ac;
                    gs[e] += as;
                }
                __syncthreads();
            }
        }
        for (int k = 0; k < nt; ++k) {
            const size_t base = (size_t)(b0 + k) * HL;
            const float* src = smem + (size_t)(4 * k + 2) * HL;
            for (int e = 4 * tid; e < HL; e += 4 * QC_THREADS) {
                const int h = e / L, idx = sidx(h, e - h * L, L);
                *reinterpret_cast<float4*>(gxr + base + e) =
                    *reinterpret_cast<const float4*>(src + idx);
                *reinterpret_cast<float4*>(gxi + base + e) =
                    *reinterpret_cast<const float4*>(src + HL + idx);
            }
        }
        __syncthreads();
    }
    cp_async_wait<0>();
}

static int fill_plan(QcPlan* plan, const int* steps, int n_steps) {
    if (n_steps < 0 || n_steps > QC_MAX_STEPS) return (int)cudaErrorInvalidValue;
    plan->n_steps = n_steps;
    for (int i = 0; i < n_steps; ++i) {
        plan->kind[i] = steps[3 * i];
        plan->axis[i] = steps[3 * i + 1];
        plan->off[i] = steps[3 * i + 2];
    }
    // the backward sweeps from the last step down, then starts over
    plan->first_mat = -1;
    for (int i = n_steps - 1; i >= 0 && plan->first_mat < 0; --i)
        if (plan->kind[i] == 0) plan->first_mat = i;
    for (int i = 0; i < n_steps; ++i) {
        int nx = -1;
        for (int j = i - 1; j >= 0 && nx < 0; --j)
            if (plan->kind[j] == 0) nx = j;
        plan->next_mat[i] = nx >= 0 ? nx : plan->first_mat;
    }
    // the forward sweeps from the first step up, then starts over
    plan->fwd_first_mat = -1;
    for (int i = 0; i < n_steps && plan->fwd_first_mat < 0; ++i)
        if (plan->kind[i] == 0) plan->fwd_first_mat = i;
    for (int i = 0; i < n_steps; ++i) {
        int nx = -1;
        for (int j = i + 1; j < n_steps && nx < 0; ++j)
            if (plan->kind[j] == 0) nx = j;
        plan->fwd_next_mat[i] = nx >= 0 ? nx : plan->fwd_first_mat;
    }
    return 0;
}

// The backward's tile of samples T and Mct buffers NB: two samples and two
// buffers where both blocks are at most 64 wide, else (a 128-wide block at
// 12 qubits) one of each; either fits a CTA (bwd_config in
// ops/block_kernel.py mirrors this). Returns the bytes.
static size_t bwd_config(int H, int L, int* T, int* NB) {
    const int KM = H > L ? H : L;
    *T = KM <= 64 ? QC_TILE : 1;
    *NB = KM <= 64 ? 2 : 1;
    return sizeof(float) * (4 * (size_t)*T * H * L + 2 * (size_t)*NB * KM * KM);
}

static int pow2_at_least_32(int x) { return x >= 32 && (x & (x - 1)) == 0; }

// Opt a kernel in to `smem` bytes of dynamic shared memory on the current
// device. The attribute is fixed per plan shape, so it is set only when a
// launch needs more than was set before on that device.
#define QC_MAX_DEVICES 64
static int opt_in_smem(const void* kernel, size_t smem, size_t* done) {
    int dev = 0;
    int err = (int)cudaGetDevice(&dev);
    if (err) return err;
    if (dev >= QC_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (smem <= done[dev]) return 0;
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (!err) done[dev] = smem;
    return err;
}

static size_t fwd_smem_done[QC_MAX_DEVICES];
static size_t bwd_smem_done[QC_MAX_DEVICES];

extern "C" const char* qc_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// K1 with a tile of T samples, NB matrix buffers and a grid of G CTAs, as
// the caller picks them (fwd_config in ops/block_kernel.py); refused unless
// T is within K1's register tile and the tile fits a CTA's shared memory.
extern "C" int qc_block_chain_fwd(const float* xr, const float* xi,
                                  const float* mats, const float* phases,
                                  float* yr, float* yi, int B, int H, int L,
                                  const int* steps, int n_steps, int T, int NB,
                                  int G, void* stream) {
    // as the backward's: tensor-core tiles, 16-byte state and matrix
    // copies, 8-byte phase loads
    if (!pow2_at_least_32(H) || !pow2_at_least_32(L) || H * L > 4096 || B < 1 ||
        G < 1 || T < 1 || T > QC_FWD_TILE || (NB != 1 && NB != 2))
        return (int)cudaErrorInvalidValue;
    const int KM = H > L ? H : L;
    const size_t smem =
        sizeof(float) * (2 * (size_t)T * H * L + 2 * (size_t)NB * KM * KM);
    if (smem > QC_SMEM_MAX) return (int)cudaErrorInvalidValue;
    const void* ptrs[5] = {xr, xi, mats, yr, yi};
    for (int i = 0; i < 5; ++i)
        if ((uintptr_t)ptrs[i] % 16) return (int)cudaErrorMisalignedAddress;
    if ((uintptr_t)phases % 8) return (int)cudaErrorMisalignedAddress;
    QcPlan plan;
    int err = fill_plan(&plan, steps, n_steps);
    if (err) return err;
    err = opt_in_smem((const void*)block_chain_fwd_kernel, smem, fwd_smem_done);
    if (err) return err;
    block_chain_fwd_kernel<<<G, QC_THREADS, smem, (cudaStream_t)stream>>>(
        xr, xi, mats, phases, yr, yi, B, H, L, T, NB, plan);
    return (int)cudaGetLastError();
}

extern "C" int qc_block_chain_bwd(const float* yr, const float* yi,
                                  const float* gr, const float* gi,
                                  const float* matcts, const float* phases,
                                  float* gxr, float* gxi, float* partials,
                                  int slab, int mats_total, int B, int H,
                                  int L, const int* steps, int n_steps, int G,
                                  void* stream) {
    // the tensor-core tiles need both blocks 32 wide or more, and the
    // 16-byte copies aligned inputs
    if (!pow2_at_least_32(H) || !pow2_at_least_32(L) || H * L > 4096)
        return (int)cudaErrorInvalidValue;
    const void* ptrs[7] = {yr, yi, gr, gi, matcts, gxr, gxi};
    for (int i = 0; i < 7; ++i)
        if ((uintptr_t)ptrs[i] % 16) return (int)cudaErrorMisalignedAddress;
    QcPlan plan;
    int err = fill_plan(&plan, steps, n_steps);
    if (err) return err;
    int T = 0, NB = 0;
    const size_t smem = bwd_config(H, L, &T, &NB);
    err = opt_in_smem((const void*)block_chain_bwd_kernel, smem, bwd_smem_done);
    if (err) return err;
    block_chain_bwd_kernel<<<G, QC_THREADS, smem, (cudaStream_t)stream>>>(
        yr, yi, gr, gi, matcts, phases, gxr, gxi, partials, slab, mats_total,
        B, H, L, T, NB, plan);
    return (int)cudaGetLastError();
}

// K2b, for both pairs' slabs (slab_sum.cuh).
extern "C" int qc_block_chain_reduce(const float* partials, float* out,
                                     int slab, int G, void* stream) {
    return slab_sum_launch(partials, out, slab, G, stream);
}
