// The span recorder's mark (qcpinn_tpu_torch/utils/spans.py), for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package traces with jax.profiler, whose
// scopes vanish inside a compiled step as record_function's vanish inside a
// CUDA graph's replay. A span edge launches this kernel on the current
// stream; it writes the device's global nanosecond timer into its slot of
// the stamp buffer. Stream order makes the stamp the time at which all work
// launched before the edge had finished, and the kernel is captured into a
// graph like any other, so every replay stamps every edge again.
//
// What bounds it: one thread, one 8-byte store; its cost is the launch (a
// graph node, about a microsecond), which is why a step has few edges.

#include <cuda_runtime.h>

extern "C" __global__ void qc_span_mark(unsigned long long* stamps, int slot) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    stamps[slot] = t;
}

extern "C" const char* qc_span_mark_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

extern "C" int qc_span_mark_launch(unsigned long long* stamps, int slot, void* stream) {
    qc_span_mark<<<1, 1, 0, (cudaStream_t)stream>>>(stamps, slot);
    return (int)cudaGetLastError();
}
