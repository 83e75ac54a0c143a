// Shared by gate_loop.cu and unrolled_sv.cu, the two kernel families that
// walk a gate table: the table itself, the amplitude-pair and quad
// addressing, the 2x2 and 4x4 updates, the fixed-order block and slab
// reductions, and the launch helpers.
//
// A sample's state is a row of 2^n split re/im f32 amplitudes, wire 0 the
// most significant bit; the partner of amplitude i across bit g is
// i ^ (1 << g).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#define GT_MAX_STEPS 768
#define GT_MAX_THREADS 512
#define GT_MAX_WARPS (GT_MAX_THREADS / 32)
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

// v[r] <- sum_c U[r][c] v[c] (or conj(U[c][r]) when CT) on one quad; u is
// a [32] bank row, the 16 complex entries row-major.
template <bool CT>
__device__ __forceinline__ void apply4(float* sr, float* si, const int idx[4],
                                       const float* u) {
    float ar[4], ai[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        ar[c] = sr[idx[c]];
        ai[c] = si[idx[c]];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        float accr = 0.f, acci = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int e = CT ? (c * 4 + r) * 2 : (r * 4 + c) * 2;
            const float ur = u[e];
            const float ui = CT ? -u[e + 1] : u[e + 1];
            accr = fmaf(ur, ar[c], fmaf(-ui, ai[c], accr));
            acci = fmaf(ur, ai[c], fmaf(ui, ar[c], acci));
        }
        sr[idx[r]] = accr;
        si[idx[r]] = acci;
    }
}

// (yr + i yi) = (ar + i ai)(xr + i xi) + (br + i bi)(zr + i zi)
__device__ __forceinline__ void cmadd2(float ar, float ai, float xr, float xi,
                                       float br, float bi, float zr, float zi,
                                       float& yr, float& yi) {
    yr = fmaf(ar, xr, fmaf(-ai, xi, fmaf(br, zr, -bi * zi)));
    yi = fmaf(ar, xi, fmaf(ai, xr, fmaf(br, zi, bi * zr)));
}

// Sum v[8] over the block in a fixed order; the result lands in thread 0.
// blockDim.x is a multiple of 32, at most GT_MAX_THREADS; red holds
// GT_MAX_WARPS * 8 floats of shared memory.
__device__ __forceinline__ void block_sum8(float v[8], float* red) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            v[e] += __shfl_down_sync(0xffffffffu, v[e], off);
    if (lane == 0)
#pragma unroll
        for (int e = 0; e < 8; ++e) red[warp * 8 + e] = v[e];
    __syncthreads();
    if (warp == 0) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            v[e] = lane < n_warps ? red[lane * 8 + e] : 0.f;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                v[e] += __shfl_down_sync(0xffffffffu, v[e], off);
        }
    }
}

// out[e] = sum_{c < G} partials[c][e], in a fixed order (grid-stride over e).
__device__ __forceinline__ void slab_sum(const float* __restrict__ partials,
                                         float* __restrict__ out, int slab,
                                         int G) {
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < slab;
         e += gridDim.x * blockDim.x) {
        float acc = 0.f;
        for (int c = 0; c < G; ++c) acc += partials[(size_t)c * slab + e];
        out[e] = acc;
    }
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
