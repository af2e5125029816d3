// framepump — native multi-stream frame ingest runtime.
//
// TPU-era equivalent of the reference's host-side platform layer ("mz",
// mz.h:19-25) and its camera-frame conversion kernels: the device computes
// (JAX/XLA), while this C++ library owns everything between the camera
// sockets and the device batch:
//
//   * pixel-format conversion (YCbCr 4:2:2 deinterleave, RGBA->R) with
//     SIMD-friendly loops (the NEON kernels' role, cv/convert.cpp)
//   * a lock-free latest-frame ring per stream (seqlock versioning), so
//     producer camera threads never block the serving loop
//   * batch assembly: gather the freshest frame of every stream into one
//     contiguous (S, H, W) buffer ready for device upload
//
// Built as a plain C ABI shared library; Python binds via ctypes
// (runtime/ingest.py). The port's own copy of the JAX package's frame pump,
// byte for byte the same functions.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>

extern "C" {

// ---------------------------------------------------------------------------
// pixel-format conversions
// ---------------------------------------------------------------------------

// Deinterleave a 2-channel interleaved image into two planes.
// channel1 gets even-index bytes, channel2 odd-index (matching the
// deinterleave convention of the reference's NEON path, cv/convert.cpp:58-60).
void fp_deinterleave_c2(const uint8_t* interleaved, uint8_t* channel1,
                        uint8_t* channel2, int64_t n_pixels) {
  for (int64_t i = 0; i < n_pixels; ++i) {
    channel1[i] = interleaved[2 * i];
    channel2[i] = interleaved[2 * i + 1];
  }
}

// Extract the R plane from interleaved RGBA (dmz_deinterleave_RGBA_to_R,
// dmz.cpp:66-110).
void fp_rgba_to_r(const uint8_t* rgba, uint8_t* r, int64_t n_pixels) {
  for (int64_t i = 0; i < n_pixels; ++i) {
    r[i] = rgba[4 * i];
  }
}

// CbYCrY 4:2:2 -> planar Y + upsampled Cb/Cr half-planes (the camera
// format the host apps feed the reference; Cb/Cr stay half-width as the
// reference expects, dmz.cpp:383).
void fp_ycbcr422_split(const uint8_t* cbycry, uint8_t* y, uint8_t* cb,
                       uint8_t* cr, int64_t width, int64_t height) {
  const int64_t pairs = width / 2;
  for (int64_t row = 0; row < height; ++row) {
    const uint8_t* src = cbycry + row * width * 2;
    uint8_t* yrow = y + row * width;
    uint8_t* cbrow = cb + row * pairs;
    uint8_t* crrow = cr + row * pairs;
    for (int64_t p = 0; p < pairs; ++p) {
      cbrow[p] = src[4 * p + 0];
      yrow[2 * p] = src[4 * p + 1];
      crrow[p] = src[4 * p + 2];
      yrow[2 * p + 1] = src[4 * p + 3];
    }
  }
}

// ---------------------------------------------------------------------------
// multi-stream latest-frame ring
// ---------------------------------------------------------------------------

struct StreamSlot {
  std::atomic<uint64_t> seq{0};  // even = stable, odd = writer active
  std::atomic<uint64_t> frame_id{0};
  uint8_t* data = nullptr;
};

struct FramePump {
  int64_t n_streams = 0;
  int64_t frame_bytes = 0;
  StreamSlot* slots = nullptr;
  uint8_t* storage = nullptr;
};

FramePump* fp_create(int64_t n_streams, int64_t frame_bytes) {
  FramePump* pump = new (std::nothrow) FramePump();
  if (!pump) return nullptr;
  pump->n_streams = n_streams;
  pump->frame_bytes = frame_bytes;
  pump->slots = new (std::nothrow) StreamSlot[n_streams];
  pump->storage = new (std::nothrow) uint8_t[n_streams * frame_bytes]();
  if (!pump->slots || !pump->storage) {
    delete[] pump->slots;
    delete[] pump->storage;
    delete pump;
    return nullptr;
  }
  for (int64_t s = 0; s < n_streams; ++s) {
    pump->slots[s].data = pump->storage + s * frame_bytes;
  }
  return pump;
}

void fp_destroy(FramePump* pump) {
  if (!pump) return;
  delete[] pump->slots;
  delete[] pump->storage;
  delete pump;
}

// Producer: publish a new frame for `stream`. Seqlock write: bump to odd,
// copy, bump to even. Callers are one-producer-per-stream (camera thread).
int fp_push_frame(FramePump* pump, int64_t stream, const uint8_t* frame,
                  uint64_t frame_id) {
  if (stream < 0 || stream >= pump->n_streams) return -1;
  StreamSlot& slot = pump->slots[stream];
  uint64_t s = slot.seq.load(std::memory_order_relaxed);
  slot.seq.store(s + 1, std::memory_order_release);  // odd: writing
  std::memcpy(slot.data, frame, pump->frame_bytes);
  slot.frame_id.store(frame_id, std::memory_order_relaxed);
  slot.seq.store(s + 2, std::memory_order_release);  // even: stable
  return 0;
}

// Consumer: gather the latest stable frame of every stream into `batch`
// ((n_streams, frame_bytes) contiguous). Seqlock read with retry. Writes
// each stream's frame_id into frame_ids. Returns number of streams whose
// frame changed since last_ids (also updates last_ids).
int64_t fp_acquire_batch(FramePump* pump, uint8_t* batch,
                         uint64_t* frame_ids, uint64_t* last_ids) {
  int64_t fresh = 0;
  for (int64_t s = 0; s < pump->n_streams; ++s) {
    StreamSlot& slot = pump->slots[s];
    uint8_t* dst = batch + s * pump->frame_bytes;
    uint64_t fid = 0;
    for (;;) {
      uint64_t before = slot.seq.load(std::memory_order_acquire);
      if (before & 1) continue;  // writer active
      std::memcpy(dst, slot.data, pump->frame_bytes);
      fid = slot.frame_id.load(std::memory_order_relaxed);
      std::atomic_thread_fence(std::memory_order_acquire);
      uint64_t after = slot.seq.load(std::memory_order_relaxed);
      if (before == after) break;  // consistent snapshot
    }
    if (frame_ids) frame_ids[s] = fid;
    if (last_ids && fid != last_ids[s]) {
      last_ids[s] = fid;
      ++fresh;
    }
  }
  return fresh;
}

}  // extern "C"
