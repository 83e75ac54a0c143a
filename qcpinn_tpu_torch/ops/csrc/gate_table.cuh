// Shared by gate_loop.cu and unrolled_sv.cu, the two kernel families that
// walk a gate table: the table itself, the amplitude-pair and quad
// addressing, the 2x2 update, the launch helpers, and the split of one
// sample over a thread-block cluster with its fixed-order sum across ranks
// (gate_loop.cu).
//
// A sample's state is a row of 2^n split re/im f32 amplitudes, wire 0 the
// most significant bit; the partner of amplitude i across bit g is
// i ^ (1 << g).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

#define GT_MAX_STEPS 768
#define GT_MAX_THREADS 512
#define GT_MAX_DEVICES 64

// One 32-bit word per step: kind[0:2] | ga[2:7] | gb[7:12] | ctrl[12] |
// idx[16:32]. Passed by value, so it lives in the kernel's constant bank.
struct GtTable {
    int n_steps;
    unsigned int step[GT_MAX_STEPS];
};

struct GtStep {
    int kind, ga, gb, ctrl, idx;
};

__device__ __forceinline__ GtStep decode(unsigned int w) {
    GtStep s;
    s.kind = (int)(w & 3u);
    s.ga = (int)((w >> 2) & 31u);
    s.gb = (int)((w >> 7) & 31u);
    s.ctrl = (int)((w >> 12) & 1u);
    s.idx = (int)(w >> 16);
    return s;
}

// p with a 0 bit inserted at position g.
__device__ __forceinline__ int insert0(int p, int g) {
    return ((p >> g) << (g + 1)) | (p & ((1 << g) - 1));
}

// The four amplitude indices of quad q for bits (ga, gb), in (bit_a, bit_b)
// order: 00, 01, 10, 11.
__device__ __forceinline__ void quad_index(int q, int ga, int gb, int idx[4]) {
    const int lo = ga < gb ? ga : gb;
    const int hi = ga < gb ? gb : ga;
    const int i = insert0(insert0(q, lo), hi);
    const int A = 1 << ga, B = 1 << gb;
    idx[0] = i;
    idx[1] = i | B;
    idx[2] = i | A;
    idx[3] = i | A | B;
}

// -- the cluster partition of one sample (gate_loop.cu) -----------------------
// A sample's 2^n amplitudes are split over a thread-block cluster of
// C = 2^(n - L) CTAs: rank r holds amplitudes [r 2^L, (r + 1) 2^L) in its
// shared memory, so amplitude i lives in rank i >> L at local index
// i & (2^L - 1). A step that acts on a bit >= L (a mat's target, either bit
// of a u2q) joins amplitudes of 2 or 4 ranks (the step's group) at local
// indices that differ only in the step's bits below L; each rank of the
// group takes an equal share of the group's pairs or quads and reads and
// writes the others' entries through distributed shared memory.

// p with a bit of value v inserted at position g.
__device__ __forceinline__ int insert_bit(int p, int g, int v) {
    return insert0(p, g) | (v << g);
}

// True when the step touches another rank's amplitudes. A mat whose only
// bit >= L is its control stays local: the whole rank is active or idle.
__device__ __forceinline__ bool cross_rank(GtStep st, int L) {
    if (st.kind == 0) return st.ga >= L;
    return st.kind == 2 && (st.ga >= L || st.gb >= L);
}

// A cross-rank step as seen from one rank: entry e of an item (pair: 0, 1;
// quad: (bit_a, bit_b) = 00, 01, 10, 11) at local index l lives at local
// index l + off[e] of rank rk[e]. This rank owns n_items of the group's
// items, item j at local index cross_local(x, j).
struct GtCross {
    unsigned rk[4];
    int off[4];
    int n_items;
    int shape;  // 0 pair, 1 quad over two ranks, 2 quad over four
    int part;   // this rank's share of the group's items
    int split;  // the local bit whose value is `part` (shapes 0, 1)
    int low;    // shape 1: the quad's bit below L
};

__device__ __forceinline__ GtCross cross_plan(GtStep st, int L,
                                              unsigned rank) {
    GtCross x;
    const int DL = 1 << L;
    const int ha = st.ga >= L, hb = st.kind == 2 && st.gb >= L;
    const unsigned ma = ha ? 1u << (st.ga - L) : 0u;
    const unsigned mb = hb ? 1u << (st.gb - L) : 0u;
    const unsigned base = rank & ~(ma | mb);
    if (st.kind == 0) {
        // a pair across ranks base and base | ma at one local index; the
        // rank whose target bit is 0 takes the items whose split bit is 0.
        // The split bit is not the control bit, so the shares stay even.
        x.shape = 0;
        x.n_items = DL >> 1;
        x.part = (rank & ma) ? 1 : 0;
        x.split = (st.ctrl && st.gb == L - 1) ? L - 2 : L - 1;
        x.low = 0;
        x.rk[0] = x.rk[2] = base;
        x.rk[1] = x.rk[3] = base | ma;
#pragma unroll
        for (int e = 0; e < 4; ++e) x.off[e] = 0;
        return x;
    }
    x.n_items = DL >> 2;
    if (ha && hb) {
        x.shape = 2;
        x.part = ((rank & ma) ? 2 : 0) + ((rank & mb) ? 1 : 0);
        x.split = x.low = 0;
    } else {
        x.shape = 1;
        x.part = (rank & (ma | mb)) ? 1 : 0;
        x.split = L - 2;
        x.low = ha ? st.gb : st.ga;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const int ba = e >> 1, bb = e & 1;
        x.rk[e] = base | (ba ? ma : 0u) | (bb ? mb : 0u);
        x.off[e] = (!ha && ba ? 1 << st.ga : 0) | (!hb && bb ? 1 << st.gb : 0);
    }
    return x;
}

// The local index of this rank's item j < x.n_items.
__device__ __forceinline__ int cross_local(const GtCross& x, int j, int L) {
    if (x.shape == 0) return insert_bit(j, x.split, x.part);
    if (x.shape == 1) return insert0(insert_bit(j, x.split, x.part), x.low);
    return j + x.part * (1 << (L - 2));
}

// out[e] = v_0[e] + v_1[e] + ... over the cluster's ranks in rank order,
// where v_r is rank r's copy of the shared array v. Run by all threads of
// one CTA, between cluster barriers.
__device__ __forceinline__ void cluster_rank_sum(float* v, float* __restrict__ out,
                                                 int len) {
    cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
    const unsigned C = cl.dim_blocks().x, me = cl.block_rank();
    for (int e = threadIdx.x; e < len; e += blockDim.x) {
        float acc = 0.f;
        for (unsigned r = 0; r < C; ++r)
            acc += (r == me ? v : cl.map_shared_rank(v, r))[e];
        out[e] = acc;
    }
}

// (yr + i yi) = (ar + i ai)(xr + i xi) + (br + i bi)(zr + i zi)
__device__ __forceinline__ void cmadd2(float ar, float ai, float xr, float xi,
                                       float br, float bi, float zr, float zi,
                                       float& yr, float& yi) {
    yr = fmaf(ar, xr, fmaf(-ai, xi, fmaf(br, zr, -bi * zi)));
    yi = fmaf(ar, xi, fmaf(ai, xr, fmaf(br, zi, bi * zr)));
}

static int fill_table(GtTable* tab, const unsigned int* steps, int n_steps) {
    if (n_steps < 0 || n_steps > GT_MAX_STEPS) return (int)cudaErrorInvalidValue;
    tab->n_steps = n_steps;
    for (int i = 0; i < n_steps; ++i) tab->step[i] = steps[i];
    return 0;
}

// Opt a kernel in to `smem` bytes of dynamic shared memory on the current
// device, once per device and size.
static int opt_in_smem(const void* kernel, size_t smem, size_t* done) {
    int dev = 0;
    int err = (int)cudaGetDevice(&dev);
    if (err) return err;
    if (dev >= GT_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (smem <= done[dev] || smem <= 48 * 1024) return 0;
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (!err) done[dev] = smem;
    return err;
}
