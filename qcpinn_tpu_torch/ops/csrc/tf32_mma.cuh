// 3xTF32 complex products on Hopper's tensor cores (mma.sync m16n8k8),
// shared by the block-chain kernels: block_chain.cu's reverse sweep (K2)
// and block_chain_cluster.cu's pair (K1c / K2c).
//
// Each f32 operand splits into a TF32 high part and a TF32 low part of the
// remainder, and hi*hi + hi*lo + lo*hi accumulate in f32, which keeps the
// f32 parity the port is held to (a single TF32 pass would not).
//
// Fragments follow mma.m16n8k8's layout: with g = lane / 4, t = lane % 4,
// A holds rows g, g + 8 and columns t, t + 4; B rows t, t + 4 and column
// g; C rows g, g + 8 and columns 2t, 2t + 1. A warp's complex tile is 32
// rows x 16 columns: acc[mt][nt][re/im][4] with row m0 + 16 mt + g + 8 (e
// / 2) and column n0 + 8 nt + 2 t + e % 2 for element e.

#pragma once

#include <stdint.h>

// x = hi + lo + O(2^-22 |x|): hi is x rounded to TF32, lo the remainder
// rounded to TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
    const float rest = x - __uint_as_float(hi);
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b in 3xTF32: the two small cross terms first, then hi * hi.
__device__ __forceinline__ void mma3(float c[4], const uint32_t ah[4],
                                     const uint32_t al[4], const uint32_t bh[2],
                                     const uint32_t bl[2]) {
    mma_tf32(c, al, bh);
    mma_tf32(c, ah, bl);
    mma_tf32(c, ah, bh);
}

// acc[mt][nt][re/im] += A * B of one k-step, complex, in 3xTF32; the
// fragments are split [re/im][mt or nt][q]. (The cluster pair issues the
// same products in another order, block_chain_cluster.cu's cmma_half.)
// The tensor cores round each mma's sum toward zero, a bias that grows
// with every mma into a running sum. With FLUSH, the k-step's 6 mma of
// each output go into a fresh sum t that joins acc by an f32 add, rounded
// to nearest, so those roundings act on one k-step's partial sum only (4
// more registers and an add a k-step); the mma and their order are the
// same either way.
template <bool FLUSH>
__device__ __forceinline__ void mma_step(float acc[2][2][2][4],
                                         const uint32_t ah[2][2][4],
                                         const uint32_t al[2][2][4],
                                         const uint32_t bh[2][2][2],
                                         const uint32_t bl[2][2][2]) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
        // -B_im, exactly (the sign bit of a TF32 pattern)
        const uint32_t nh[2] = {bh[1][nt][0] ^ 0x80000000u, bh[1][nt][1] ^ 0x80000000u};
        const uint32_t nl[2] = {bl[1][nt][0] ^ 0x80000000u, bl[1][nt][1] ^ 0x80000000u};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
            if (FLUSH) {
                float t[4] = {0.f, 0.f, 0.f, 0.f};
                mma3(t, ah[0][mt], al[0][mt], bh[0][nt], bl[0][nt]);
                mma3(t, ah[1][mt], al[1][mt], nh, nl);
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[mt][nt][0][e] += t[e];
                float u[4] = {0.f, 0.f, 0.f, 0.f};
                mma3(u, ah[0][mt], al[0][mt], bh[1][nt], bl[1][nt]);
                mma3(u, ah[1][mt], al[1][mt], bh[0][nt], bl[0][nt]);
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[mt][nt][1][e] += u[e];
            } else {
                mma3(acc[mt][nt][0], ah[0][mt], al[0][mt], bh[0][nt], bl[0][nt]);
                mma3(acc[mt][nt][0], ah[1][mt], al[1][mt], nh, nl);
                mma3(acc[mt][nt][1], ah[0][mt], al[0][mt], bh[1][nt], bl[1][nt]);
                mma3(acc[mt][nt][1], ah[1][mt], al[1][mt], bh[0][nt], bl[0][nt]);
            }
        }
    }
}

__device__ __forceinline__ void zero_acc(float acc[2][2][2][4]) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int c = 0; c < 2; ++c)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[mt][nt][c][e] = 0.f;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
