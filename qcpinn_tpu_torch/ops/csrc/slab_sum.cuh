// The fixed-order slab sum, shared by the three backward families:
// block_chain.cu (K2b: the 12q pair's and the cluster pair's slabs),
// gate_loop.cu (K6b) and unrolled_sv.cu (K4b).
//
// Replaces the batch sums that the TPU kernels carry across their
// sequential grid (qcpinn_tpu/ops/block_pallas.py:241-244,
// pallas_loop.py:375-385, pallas_sv.py:332-337): each backward CTA (or
// cluster) writes its own slab, and this pass adds the G slabs,
//   out[e] = ((partials[0][e] + partials[1][e]) + ...) + partials[G-1][e],
// in that order, so the result is deterministic and bit-equal to the plain
// versions (block_kernel.py, loop_kernel.py, sv_kernel.py). The build has
// no fast-math, so nothing reassociates or contracts the adds.
//
// What bounds it: device memory, or L2 where the slabs were just written
// (the 12q pair's 35 MB of slabs fit in the 50 MB L2): it reads G slabs
// and writes one, one add per 4 bytes read. The order leaves one chain of
// G dependent adds per element, so what holds it back is how many loads
// the card has in flight, and the slabs come in two shapes:
//   long and few (K2b: 132 slabs of 65.5K floats at 12 qubits, 15 of 1M on
//   the cluster pair; K6b: 15 of 262K): one thread per element, the loop
//   over c unrolled by nvcc, 16 warps an SM. On the card this matched or
//   beat every variant tried that batched 4-16 rows of loads a thread,
//   used 16-byte loads or staged rows through shared memory (PERF.md);
//   short and many (K4b: 1056 slabs of 1024 floats): a thread per element
//   is 1024 threads on 132 SMs, each waiting on its loads one by one. So a
//   CTA takes a tile of W columns (W a power of two, as wide as still
//   leaves a tile for every SM) and L = SS_THREADS / W lanes a column:
//   lane l loads rows u * L + l (u < SS_ROWS) of its column, SS_ROWS loads
//   in flight a thread and L * SS_ROWS rows a round, puts them in shared
//   memory, starts the next round's loads, and lane 0 adds the round's
//   rows in order, reading eight rows ahead of its adds.
// The launch takes the first form where it gives every SM a full CTA of
// columns (slab >= SMs * SS_THREADS), else the second. Each form is its own
// kernel, so the lanes' registers do not lower the columns' occupancy.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#define SS_THREADS 256
#define SS_ROWS 8  // loads in flight a thread, in lanes
#define SS_MAX_DEVICES 64

// The columns form: out[e] = sum_{c < G} partials[c][e], c in order, from
// +0 (so a -0 in slab 0 comes out +0, equal under ==), one thread an element.
__global__ void slab_sum_columns_kernel(const float* __restrict__ partials,
                                        float* __restrict__ out, int slab, int G) {
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < slab;
         e += gridDim.x * blockDim.x) {
        float acc = 0.f;
        for (int c = 0; c < G; ++c) acc += partials[(size_t)c * slab + e];
        out[e] = acc;
    }
}

// The lanes form: the same sum, a CTA a tile of W columns (see above).
__global__ void __launch_bounds__(SS_THREADS)
    slab_sum_lanes_kernel(const float* __restrict__ partials, float* __restrict__ out,
                          int slab, int G, int W) {
    extern __shared__ float buf[];  // [L * SS_ROWS][W]
    const int L = SS_THREADS / W;
    const int lane = threadIdx.x / W, w = threadIdx.x & (W - 1);
    const int RB = L * SS_ROWS;
    const int rounds = (G + RB - 1) / RB;
    const int tiles = (slab + W - 1) / W;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int col = tile * W + w;
        const bool live = col < slab;
        float v[SS_ROWS];
        auto load = [&](int k) {
#pragma unroll
            for (int u = 0; u < SS_ROWS; ++u) {
                const int row = k * RB + u * L + lane;
                if (live && row < G) v[u] = __ldg(partials + (size_t)row * slab + col);
            }
        };
        float acc = 0.f;
        load(0);
        for (int k = 0; k < rounds; ++k) {
#pragma unroll
            for (int u = 0; u < SS_ROWS; ++u) buf[(u * L + lane) * W + w] = v[u];
            __syncthreads();  // the round's rows are in shared memory
            if (k + 1 < rounds) load(k + 1);
            if (lane == 0 && live) {
                const int rows = min(RB, G - k * RB);
                const float* b = buf + w;
                int r = 0;
                if (rows >= 8) {
                    float x[8];
#pragma unroll
                    for (int j = 0; j < 8; ++j) x[j] = b[j * W];
                    for (; r + 16 <= rows; r += 8) {
                        float y[8];
#pragma unroll
                        for (int j = 0; j < 8; ++j) y[j] = b[(r + 8 + j) * W];
#pragma unroll
                        for (int j = 0; j < 8; ++j) acc += x[j];
#pragma unroll
                        for (int j = 0; j < 8; ++j) x[j] = y[j];
                    }
#pragma unroll
                    for (int j = 0; j < 8; ++j) acc += x[j];
                    r += 8;
                }
                for (; r < rows; ++r) acc += b[r * W];
            }
            __syncthreads();  // the adds are done with the buffer
        }
        if (lane == 0 && live) out[col] = acc;
    }
}

// The SM count of the current device and the CTAs of the lanes form it
// holds at once, asked once per device.
static int ss_card(int* sms, int* wave) {
    static int cached[SS_MAX_DEVICES][2];
    int dev = 0;
    int err = (int)cudaGetDevice(&dev);
    if (err) return err;
    if (dev >= SS_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    int* c = cached[dev];
    if (!c[1]) {
        int per_sm = 0;
        err = (int)cudaDeviceGetAttribute(&c[0], cudaDevAttrMultiProcessorCount, dev);
        if (!err)
            err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, slab_sum_lanes_kernel, SS_THREADS,
                sizeof(float) * SS_THREADS * SS_ROWS);
        if (err) return err;
        if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
        c[1] = c[0] * per_sm;
    }
    *sms = c[0];
    *wave = c[1];
    return 0;
}

// Launches the slab sum of partials [G, slab] into out [slab] on `stream`.
static int slab_sum_launch(const float* partials, float* out, int slab, int G,
                           void* stream) {
    if (slab < 0 || G < 1) return (int)cudaErrorInvalidValue;
    if (slab == 0) return 0;
    int sms = 0, wave = 0;
    int err = ss_card(&sms, &wave);
    if (err) return err;
    const bool lanes = slab < sms * SS_THREADS;
    int W = SS_THREADS;
    while (lanes && W > 1 && (slab + W - 1) / W < sms) W /= 2;
    const int tiles = (slab + W - 1) / W;
    cudaStream_t st = (cudaStream_t)stream;
    if (lanes)
        slab_sum_lanes_kernel<<<tiles > wave ? wave : tiles, SS_THREADS,
                                sizeof(float) * SS_THREADS * SS_ROWS, st>>>(
            partials, out, slab, G, W);
    else
        slab_sum_columns_kernel<<<tiles, SS_THREADS, 0, st>>>(partials, out, slab, G);
    return (int)cudaGetLastError();
}
