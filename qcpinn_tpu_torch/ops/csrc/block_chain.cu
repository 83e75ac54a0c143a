// Block-chain evolution kernels for Hopper (sm_90a), plain FP32 FMA.
//
// Replaces qcpinn_tpu/ops/block_pallas.py::_forward_kernel (K1) and
// ::_backward_kernel (K2). The state of one sample is s[H][L] in split
// re/im f32. A plan is a table of steps:
//   mat  : contract one axis with a shared complex [K, K] matrix M[in, out]
//          (axis hi: s[m][l] = sum_k M[k][m] s[k][l]; lo: s[h][m] = sum_k
//          s[h][k] M[k][m]);
//   diag : multiply by the phase planes (cos + i sin)[H][L].
//
// What bounds it: at 12 qubits (H = L = K = 64) each mat step is a
// 64x64x64 complex product per sample, so the chain does ~21 FMA per byte
// of state it reads: FP32 FMA throughput, not device memory, is the limit.
// The design therefore keeps every sample's state in shared memory for the
// whole chain (one read and one write of device memory) and gives each of
// 256 threads a 4x4 complex register tile per product (16 FMA per 2 shared
// loads). Shared rows are padded to an odd stride (L + 1, K + 1) and the
// tiles are strided (rows ty + R*r, columns tx + C*c), so every shared load
// of a warp hits distinct banks. No tensor cores: TF32 would break the
// f32 parity the port is held to.
//
// The backward sweeps the plan in reverse from the final state with O(1)
// state memory: the matrices arrive conj-transposed (Mct = conj(M)^T), and
// one contraction with Mct both recovers the step's input and pulls the
// cotangent back. The matrix and phase cotangents are sums over the batch.
// A TPU grid runs in order and can carry that sum across grid steps; CTAs
// cannot, so a persistent grid of G CTAs each sums its own samples into a
// private slab in device memory, and a second kernel adds the G slabs in a
// fixed order. No float atomics: the result is deterministic.
//
// Plain C interface (loaded with ctypes); every entry returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stddef.h>

#define QC_MAX_STEPS 128
#define QC_THREADS 256

struct QcPlan {
    int n_steps;
    int kind[QC_MAX_STEPS];  // 0 = mat, 1 = diag
    int axis[QC_MAX_STEPS];  // 0 = hi, 1 = lo (mat only)
    int off[QC_MAX_STEPS];   // float offset into the packed mats / phases
};

// acc(i, j) += sum_p opA(A(i, p)) * B(p, j) over a strided 4x4 tile:
// i = ty + R*r, j = tx + C*c. A(i, p) = a[i*a_si + p*a_sp] and
// B(p, j) = b[p*b_sp + j*b_sj], split re/im; opA conjugates when CONJ_A.
template <bool CONJ_A>
__device__ __forceinline__ void cgemm_tile(
    const float* __restrict__ ar, const float* __restrict__ ai, int a_si,
    int a_sp, const float* __restrict__ br, const float* __restrict__ bi,
    int b_sp, int b_sj, int P, int R, int C, int ty, int tx,
    float accr[4][4], float acci[4][4]) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            accr[r][c] = 0.f;
            acci[r][c] = 0.f;
        }
    int a_row[4], b_col[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a_row[r] = (ty + R * r) * a_si;
#pragma unroll
    for (int c = 0; c < 4; ++c) b_col[c] = (tx + C * c) * b_sj;
    for (int p = 0; p < P; ++p) {
        const int ap = p * a_sp;
        const int bp = p * b_sp;
        float xr[4], xi[4], yr[4], yi[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            xr[r] = ar[a_row[r] + ap];
            xi[r] = CONJ_A ? -ai[a_row[r] + ap] : ai[a_row[r] + ap];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            yr[c] = br[bp + b_col[c]];
            yi[c] = bi[bp + b_col[c]];
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
}

// Copy a dense [K][K] matrix pair from device memory into shared rows of
// stride K + 1.
__device__ __forceinline__ void load_mat(const float* __restrict__ g, int K,
                                         float* mr, float* mi) {
    const int kk = K * K;
    for (int e = threadIdx.x; e < kk; e += QC_THREADS) {
        const int k = e / K, m = e - k * K;
        mr[k * (K + 1) + m] = g[e];
        mi[k * (K + 1) + m] = g[kk + e];
    }
}

// s <- contract(s, M) along the step's axis, through registers.
__device__ __forceinline__ void mat_step(float* sr, float* si, const float* mr,
                                         const float* mi, bool hi, int H,
                                         int L) {
    const int S = L + 1;
    const int K = hi ? H : L;
    const int R = H / 4, C = L / 4;
    const int tid = threadIdx.x;
    const bool active = tid < R * C;
    const int ty = tid / C, tx = tid - (tid / C) * C;
    float accr[4][4], acci[4][4];
    if (active) {
        if (hi)
            cgemm_tile<false>(mr, mi, 1, K + 1, sr, si, S, 1, K, R, C, ty, tx,
                              accr, acci);
        else
            cgemm_tile<false>(sr, si, S, 1, mr, mi, K + 1, 1, K, R, C, ty, tx,
                              accr, acci);
    }
    __syncthreads();
    if (active) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int idx = (ty + R * r) * S + tx + C * c;
                sr[idx] = accr[r][c];
                si[idx] = acci[r][c];
            }
    }
    __syncthreads();
}

extern "C" __global__ void __launch_bounds__(QC_THREADS)
block_chain_fwd_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                       const float* __restrict__ mats,
                       const float* __restrict__ phases, float* __restrict__ yr,
                       float* __restrict__ yi, int B, int H, int L, QcPlan plan) {
    extern __shared__ float smem[];
    const int S = L + 1;
    const int KM = H > L ? H : L;
    const int HL = H * L;
    float* sr = smem;
    float* si = sr + H * S;
    float* mr = si + H * S;
    float* mi = mr + KM * (KM + 1);
    const int tid = threadIdx.x;
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
        const size_t base = (size_t)b * HL;
        for (int e = tid; e < HL; e += QC_THREADS) {
            const int h = e / L, l = e - h * L;
            sr[h * S + l] = xr[base + e];
            si[h * S + l] = xi[base + e];
        }
        __syncthreads();
        for (int st = 0; st < plan.n_steps; ++st) {
            if (plan.kind[st] == 0) {
                const bool hi = plan.axis[st] == 0;
                load_mat(mats + plan.off[st], hi ? H : L, mr, mi);
                __syncthreads();
                mat_step(sr, si, mr, mi, hi, H, L);
            } else {
                const float* pc = phases + plan.off[st];
                const float* ps = pc + HL;
                for (int e = tid; e < HL; e += QC_THREADS) {
                    const int idx = (e / L) * S + e % L;
                    const float c = pc[e], s = ps[e];
                    const float a = sr[idx], d = si[idx];
                    sr[idx] = a * c - d * s;
                    si[idx] = a * s + d * c;
                }
                __syncthreads();
            }
        }
        for (int e = tid; e < HL; e += QC_THREADS) {
            const int h = e / L, l = e - h * L;
            yr[base + e] = sr[h * S + l];
            yi[base + e] = si[h * S + l];
        }
        __syncthreads();
    }
}

extern "C" __global__ void __launch_bounds__(QC_THREADS)
block_chain_bwd_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
                       const float* __restrict__ gr, const float* __restrict__ gi,
                       const float* __restrict__ matcts,
                       const float* __restrict__ phases, float* __restrict__ gxr,
                       float* __restrict__ gxi, float* __restrict__ partials,
                       int slab, int mats_total, int B, int H, int L,
                       QcPlan plan) {
    extern __shared__ float smem[];
    const int S = L + 1;
    const int KM = H > L ? H : L;
    const int HL = H * L;
    float* sr = smem;
    float* si = sr + H * S;
    float* qr = si + H * S;
    float* qi = qr + H * S;
    float* mr = qi + H * S;
    float* mi = mr + KM * (KM + 1);
    const int tid = threadIdx.x;
    float* part = partials + (size_t)blockIdx.x * slab;
    for (int e = tid; e < slab; e += QC_THREADS) part[e] = 0.f;
    __syncthreads();
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
        const size_t base = (size_t)b * HL;
        for (int e = tid; e < HL; e += QC_THREADS) {
            const int idx = (e / L) * S + e % L;
            sr[idx] = yr[base + e];
            si[idx] = yi[base + e];
            qr[idx] = gr[base + e];
            qi[idx] = gi[base + e];
        }
        __syncthreads();
        for (int st = plan.n_steps - 1; st >= 0; --st) {
            if (plan.kind[st] == 0) {
                const bool hi = plan.axis[st] == 0;
                const int K = hi ? H : L;
                load_mat(matcts + plan.off[st], K, mr, mi);
                __syncthreads();
                // input recovery: s_in = contract(s_out, conj(M)^T)
                mat_step(sr, si, mr, mi, hi, H, L);
                // dM[k][m] = sum over the other axis of conj(s_in) * g_out
                // RK*RK tiles of 4x4; more tiles than threads once K > 64
                // (an uneven split), so each thread walks its share
                const int RK = K / 4;
                for (int t = tid; t < RK * RK; t += QC_THREADS) {
                    const int ty = t / RK, tx = t - (t / RK) * RK;
                    float accr[4][4], acci[4][4];
                    if (hi)  // sum_l conj(s[k][l]) g[m][l]
                        cgemm_tile<true>(sr, si, S, 1, qr, qi, 1, S, L, RK, RK,
                                         ty, tx, accr, acci);
                    else  // sum_h conj(s[h][k]) g[h][m]
                        cgemm_tile<true>(sr, si, 1, S, qr, qi, S, 1, H, RK, RK,
                                         ty, tx, accr, acci);
                    float* pr = part + plan.off[st];
                    float* pi = pr + K * K;
#pragma unroll
                    for (int r = 0; r < 4; ++r)
#pragma unroll
                        for (int c = 0; c < 4; ++c) {
                            const int idx = (ty + RK * r) * K + tx + RK * c;
                            pr[idx] += accr[r][c];
                            pi[idx] += acci[r][c];
                        }
                }
                // cotangent pullback with the same conj-transposed matrix
                mat_step(qr, qi, mr, mi, hi, H, L);
            } else {
                const float* pc = phases + plan.off[st];
                const float* ps = pc + HL;
                float* gc = part + mats_total + plan.off[st];
                float* gs = gc + HL;
                for (int e = tid; e < HL; e += QC_THREADS) {
                    const int idx = (e / L) * S + e % L;
                    const float c = pc[e], s = ps[e];
                    // input recovery: conjugate phase
                    const float a = c * sr[idx] + s * si[idx];
                    const float d = c * si[idx] - s * sr[idx];
                    sr[idx] = a;
                    si[idx] = d;
                    const float u = qr[idx], v = qi[idx];
                    // phase cotangents (out = (c + i s) * in)
                    gc[e] += u * a + v * d;
                    gs[e] += -u * d + v * a;
                    qr[idx] = c * u + s * v;
                    qi[idx] = c * v - s * u;
                }
                __syncthreads();
            }
        }
        for (int e = tid; e < HL; e += QC_THREADS) {
            const int idx = (e / L) * S + e % L;
            gxr[base + e] = qr[idx];
            gxi[base + e] = qi[idx];
        }
        __syncthreads();
    }
}

// out[e] = sum_{c < G} partials[c][e], in a fixed order.
extern "C" __global__ void block_chain_reduce_kernel(
    const float* __restrict__ partials, float* __restrict__ out, int slab,
    int G) {
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < slab;
         e += gridDim.x * blockDim.x) {
        float acc = 0.f;
        for (int c = 0; c < G; ++c) acc += partials[(size_t)c * slab + e];
        out[e] = acc;
    }
}

static int fill_plan(QcPlan* plan, const int* steps, int n_steps) {
    if (n_steps < 0 || n_steps > QC_MAX_STEPS) return (int)cudaErrorInvalidValue;
    plan->n_steps = n_steps;
    for (int i = 0; i < n_steps; ++i) {
        plan->kind[i] = steps[3 * i];
        plan->axis[i] = steps[3 * i + 1];
        plan->off[i] = steps[3 * i + 2];
    }
    return 0;
}

static size_t smem_bytes(int H, int L, int state_planes) {
    const int KM = H > L ? H : L;
    return sizeof(float) *
           ((size_t)state_planes * H * (L + 1) + 2 * (size_t)KM * (KM + 1));
}

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

extern "C" int qc_block_chain_fwd(const float* xr, const float* xi,
                                  const float* mats, const float* phases,
                                  float* yr, float* yi, int B, int H, int L,
                                  const int* steps, int n_steps, void* stream) {
    QcPlan plan;
    int err = fill_plan(&plan, steps, n_steps);
    if (err) return err;
    const size_t smem = smem_bytes(H, L, 2);
    err = opt_in_smem((const void*)block_chain_fwd_kernel, smem, fwd_smem_done);
    if (err) return err;
    block_chain_fwd_kernel<<<B, QC_THREADS, smem, (cudaStream_t)stream>>>(
        xr, xi, mats, phases, yr, yi, B, H, L, plan);
    return (int)cudaGetLastError();
}

extern "C" int qc_block_chain_bwd(const float* yr, const float* yi,
                                  const float* gr, const float* gi,
                                  const float* matcts, const float* phases,
                                  float* gxr, float* gxi, float* partials,
                                  int slab, int mats_total, int B, int H,
                                  int L, const int* steps, int n_steps, int G,
                                  void* stream) {
    QcPlan plan;
    int err = fill_plan(&plan, steps, n_steps);
    if (err) return err;
    const size_t smem = smem_bytes(H, L, 4);
    err = opt_in_smem((const void*)block_chain_bwd_kernel, smem, bwd_smem_done);
    if (err) return err;
    block_chain_bwd_kernel<<<G, QC_THREADS, smem, (cudaStream_t)stream>>>(
        yr, yi, gr, gi, matcts, phases, gxr, gxi, partials, slab, mats_total,
        B, H, L, plan);
    return (int)cudaGetLastError();
}

extern "C" int qc_block_chain_reduce(const float* partials, float* out,
                                     int slab, int G, void* stream) {
    const int blocks = (slab + QC_THREADS - 1) / QC_THREADS;
    block_chain_reduce_kernel<<<blocks, QC_THREADS, 0, (cudaStream_t)stream>>>(
        partials, out, slab, G);
    return (int)cudaGetLastError();
}
