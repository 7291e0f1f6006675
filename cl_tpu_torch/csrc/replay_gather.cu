// Replay-buffer gather on the device: out[i] = buffer[idx[i]] over rows of
// bytes.
//
// Replaces the TPU kernel cl_tpu/pallas/replay_gather.py::_gather_kernel
// (launched at replay_gather.py:76), which moved each sampled row HBM to HBM
// by one DMA per grid step, with the index vector scalar-prefetched. Here a
// row is any number of bytes: the buffer [N, row_bytes] (uint8 images or
// masks of the device-resident replay buffer), idx [k] int32 on the device.
// The TPU version fell back to an XLA gather for rows that are not a
// multiple of 128 lanes; this kernel takes every row length.
//
// What bounds it on the H100: bytes, k rows read and written (one 576 x 576
// RGB row is 995,328 bytes, ~0.6 us at 3.35 TB/s), so at the k = 1 to 8 rows
// a training step samples it is bound by its launch.
//
// Design: a 2-D grid, one row of it per sampled row and up to kGatherChunks
// blocks along each row; each block reads its row's index from device
// memory itself (no host round trip, no scalar prefetch) and copies a
// strided run of words. The word is 16 bytes where the row length and both
// base pointers allow it, else 4, else 1 (the wrapper picks it). An index
// outside [0, N) copies nothing and zeroes its output row.

#include "common.cuh"

namespace cltorch {
namespace {

constexpr int kGatherThreads = 256;
constexpr int kGatherChunks = 256;  // most blocks along one row

template <typename W>
__global__ void __launch_bounds__(kGatherThreads)
replay_gather_kernel(const W* __restrict__ buf, const int* __restrict__ idx, W* __restrict__ out,
                     int64_t row_words, int n_rows) {
  const int i = blockIdx.y;
  const int r = idx[i];
  W* dst = out + (int64_t)i * row_words;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t j0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r < 0 || r >= n_rows) {
    for (int64_t j = j0; j < row_words; j += stride) dst[j] = W{};
    return;
  }
  const W* src = buf + (int64_t)r * row_words;
  for (int64_t j = j0; j < row_words; j += stride) dst[j] = src[j];
}

template <typename W>
int gather_launch(const void* buf, const void* idx, void* out, int64_t row_bytes, int n_rows,
                  int k, cudaStream_t st) {
  const int64_t words = row_bytes / (int64_t)sizeof(W);
  int64_t chunks = (words + kGatherThreads - 1) / kGatherThreads;
  chunks = chunks < 1 ? 1 : (chunks > kGatherChunks ? kGatherChunks : chunks);
  replay_gather_kernel<W><<<dim3((unsigned)chunks, (unsigned)k), kGatherThreads, 0, st>>>(
      static_cast<const W*>(buf), static_cast<const int*>(idx), static_cast<W*>(out), words,
      n_rows);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cltorch

// Plain C interface, loaded with ctypes; returns cudaGetLastError() (0 =
// launched). word_bytes is 16, 4 or 1, and divides row_bytes and both
// pointers (checked by cl_tpu_torch/kernels/replay_gather.py); 1 <= k <= 65535.
extern "C" {

int cltorch_replay_gather(const void* buf, const void* idx, void* out, int64_t row_bytes,
                          int n_rows, int k, int word_bytes, void* stream) {
  using namespace cltorch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (word_bytes == 16) return gather_launch<uint4>(buf, idx, out, row_bytes, n_rows, k, st);
  if (word_bytes == 4) return gather_launch<uint32_t>(buf, idx, out, row_bytes, n_rows, k, st);
  return gather_launch<uint8_t>(buf, idx, out, row_bytes, n_rows, k, st);
}

}  // extern "C"
