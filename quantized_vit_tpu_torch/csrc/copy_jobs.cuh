// The copy jobs of the in-kernel weight gather (FSDP serving): K14
// (ring_gather.cu) copies them alone, K15 (fused_mlp.cu's kernel with a
// copy) inside K2's MLP launch.
//
// A gather is a list of jobs (src, dst, bytes) handed over by value in
// the kernel's parameters: each of this process's row shards into its own
// row slot of its output and into the same slot of every peer's output,
// through the pointers that CUDA IPC mapped into this process
// (ops/ring_gather.py plans them). The bytes are copied opaquely (int8
// levels, packed int4, bf16), 16 bytes a thread where source, destination
// and length allow it, else byte by byte.
//
// K15 cuts each job into chunks of `chunk` bytes (a multiple of 4096, so
// every chunk keeps its job's 16-byte alignment), numbered job by job;
// the split is ops/fused.py:gather_split's, from the gather's bytes and
// the MLP's grid.
#pragma once

#include <cstdint>

#include "qvt_common.cuh"

namespace qvt {

constexpr int MAX_JOBS = 64;

struct Jobs {
  const int8_t* src[MAX_JOBS];
  int8_t* dst[MAX_JOBS];
  long long bytes[MAX_JOBS];
  int n;
};

// bytes [0, n) of s into d, by the threads tid of a group of `stride`:
// 16-byte pieces with four loads in flight before the stores where s and
// d are 16-byte aligned, then the tail byte by byte
__device__ __forceinline__ void copy_bytes(const int8_t* s, int8_t* d,
                                           long long n, long long tid,
                                           long long stride) {
  const bool vec = ((reinterpret_cast<uintptr_t>(s) |
                     reinterpret_cast<uintptr_t>(d)) & 15) == 0;
  const long long n16 = vec ? n / 16 : 0;
  const uint4* s4 = reinterpret_cast<const uint4*>(s);
  uint4* d4 = reinterpret_cast<uint4*>(d);
  for (long long i = tid; i < n16; i += 4 * stride) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i + u * stride < n16) v[u] = __ldcs(s4 + i + u * stride);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i + u * stride < n16) __stcs(d4 + i + u * stride, v[u]);
  }
  for (long long i = n16 * 16 + tid; i < n; i += stride) d[i] = s[i];
}

// every job, spread over the threads [0, nb * nt) of a grid of nb blocks
// of nt threads (K14)
__device__ __forceinline__ void copy_jobs(const Jobs& jb, int b, int nb,
                                          int nt) {
  const long long tid = static_cast<long long>(b) * nt + threadIdx.x;
  const long long stride = static_cast<long long>(nb) * nt;
  for (int j = 0; j < jb.n; ++j)
    copy_bytes(jb.src[j], jb.dst[j], jb.bytes[j], tid, stride);
}

// chunk c of the jobs cut into `chunk`-byte pieces, by the nt threads of
// one block (K15)
__device__ __forceinline__ void copy_chunk(const Jobs& jb, long long chunk,
                                           long long c, int nt) {
  for (int j = 0; j < jb.n; ++j) {
    const long long n = jb.bytes[j], pieces = (n + chunk - 1) / chunk;
    if (c < pieces) {
      const long long o = c * chunk;
      copy_bytes(jb.src[j] + o, jb.dst[j] + o,
                 n - o < chunk ? n - o : chunk, threadIdx.x, nt);
      return;
    }
    c -= pieces;
  }
}

// the chunks of the jobs at `chunk` bytes a piece
inline long long count_chunks(const Jobs& jb, long long chunk) {
  long long c = 0;
  for (int j = 0; j < jb.n; ++j) c += (jb.bytes[j] + chunk - 1) / chunk;
  return c;
}

// the jobs from host arrays of pointers and sizes; an error code if there
// are more than MAX_JOBS or a size is negative
inline int fill_jobs(Jobs& jb, const long long* src, const long long* dst,
                     const long long* bytes, int n_jobs) {
  if (n_jobs < 0 || n_jobs > MAX_JOBS)
    return static_cast<int>(cudaErrorInvalidValue);
  jb.n = n_jobs;
  for (int j = 0; j < n_jobs; ++j) {
    if (bytes[j] < 0) return static_cast<int>(cudaErrorInvalidValue);
    jb.src[j] = reinterpret_cast<const int8_t*>(src[j]);
    jb.dst[j] = reinterpret_cast<int8_t*>(dst[j]);
    jb.bytes[j] = bytes[j];
  }
  return 0;
}

}  // namespace qvt
