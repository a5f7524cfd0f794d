// CSTPack native reader: the host side of the port's ingest path, built
// with g++ at first use (cstp_tpu_torch/ops/build.py build_host) and bound
// with ctypes (cstp_tpu_torch/data/native_reader.py). The same source and C
// interface as the JAX package's native reader, so the two libraries give
// bitwise the same frames.
//
// It mmaps one shard, decodes JPEG frames with libjpeg (setjmp error
// recovery: a corrupt frame is counted and zero-filled, never exit()),
// resizes with a fixed-point bilinear filter, and fills a whole batch in
// place from a pthread pool; cstp_decode_blobs runs the same decode over
// independent JPEG blobs (the LMDB reader's frames).
//
// Where libjpeg's header is absent (or CSTP_NO_JPEG is defined, as
// ops/build.py does when its probe finds no jpeglib.h), the JPEG decode is
// compiled out: raw-codec shards are served as before, every JPEG frame
// counts as an error, and cstp_has_jpeg() returns 0 so that the binding
// refuses JPEG shards instead of returning zero-filled frames.
//
// Format (little-endian, no struct padding; cstp_tpu_torch/data/packed.py
// writes it):
//   'CSTP' | u32 version | u64 n_videos | u64 index_offset
//   body: concatenated frame blobs
//   index per video: i32 label, i32 nframes, u8 codec, u16 raw_h, u16 raw_w,
//                    u16 path_len, path bytes, u64 offsets[nframes+1]

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#if __has_include(<jpeglib.h>) && !defined(CSTP_NO_JPEG)
#define CSTP_HAVE_JPEG 1
#include <jpeglib.h>
#include <csetjmp>
#else
#define CSTP_HAVE_JPEG 0
#endif

namespace {

constexpr uint8_t kCodecJpeg = 0;
constexpr uint8_t kCodecRaw = 1;

struct VideoIndex {
  int32_t label;
  int32_t nframes;
  uint8_t codec;
  uint16_t raw_h, raw_w;
  std::string path;
  const uint64_t* offsets;  // points into the mmap
};

struct Pack {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  std::vector<VideoIndex> index;
};

template <typename T>
T ReadLE(const uint8_t*& p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  p += sizeof(T);
  return v;
}

#if CSTP_HAVE_JPEG
// --- libjpeg with error recovery (no exit() on corrupt frames) ---
struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void JpegErrorExit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

// Decode a JPEG blob to RGB. Returns w*h*3 buffer via out; false on error.
bool DecodeJpeg(const uint8_t* blob, size_t len, std::vector<uint8_t>* out,
                int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = JpegErrorExit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(blob), len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  out->resize(size_t(*w) * (*h) * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() + size_t(cinfo.output_scanline) * (*w) * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}
#else
// Built without libjpeg: no JPEG frame decodes.
bool DecodeJpeg(const uint8_t*, size_t, std::vector<uint8_t>*, int*, int*) {
  return false;
}
#endif

// Fixed-point (16.16) bilinear resize, RGB u8.
void ResizeBilinear(const uint8_t* src, int sw, int sh, uint8_t* dst, int dw,
                    int dh) {
  if (sw == dw && sh == dh) {
    std::memcpy(dst, src, size_t(dw) * dh * 3);
    return;
  }
  const int64_t x_ratio = (int64_t(sw) << 16) / dw;
  const int64_t y_ratio = (int64_t(sh) << 16) / dh;
  for (int y = 0; y < dh; ++y) {
    // PIL-style half-pixel centers
    int64_t sy = ((int64_t(2 * y + 1) * y_ratio) >> 1) - (1 << 15);
    if (sy < 0) sy = 0;
    int y0 = int(sy >> 16);
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    int fy = int(sy & 0xFFFF);
    for (int x = 0; x < dw; ++x) {
      int64_t sx = ((int64_t(2 * x + 1) * x_ratio) >> 1) - (1 << 15);
      if (sx < 0) sx = 0;
      int x0 = int(sx >> 16);
      int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      int fx = int(sx & 0xFFFF);
      const uint8_t* p00 = src + (size_t(y0) * sw + x0) * 3;
      const uint8_t* p01 = src + (size_t(y0) * sw + x1) * 3;
      const uint8_t* p10 = src + (size_t(y1) * sw + x0) * 3;
      const uint8_t* p11 = src + (size_t(y1) * sw + x1) * 3;
      uint8_t* d = dst + (size_t(y) * dw + x) * 3;
      for (int c = 0; c < 3; ++c) {
        int64_t top = (int64_t(p00[c]) << 16) + int64_t(p01[c] - p00[c]) * fx;
        int64_t bot = (int64_t(p10[c]) << 16) + int64_t(p11[c] - p10[c]) * fx;
        int64_t val = top + (((bot - top) >> 8) * fy >> 8);
        d[c] = uint8_t((val + (1 << 15)) >> 16);
      }
    }
  }
}

// Decode+resize one frame of one video into dst (out_h*out_w*3).
bool ReadFrame(const Pack* p, int vid, int frame, int out_h, int out_w,
               uint8_t* dst) {
  if (vid < 0 || size_t(vid) >= p->index.size()) return false;
  const VideoIndex& v = p->index[vid];
  if (frame < 0 || frame >= v.nframes) return false;
  const uint8_t* blob = p->base + v.offsets[frame];
  size_t len = size_t(v.offsets[frame + 1] - v.offsets[frame]);
  if (v.codec == kCodecRaw) {
    ResizeBilinear(blob, v.raw_w, v.raw_h, dst, out_w, out_h);
    return true;
  }
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  if (!DecodeJpeg(blob, len, &rgb, &w, &h)) return false;
  ResizeBilinear(rgb.data(), w, h, dst, out_w, out_h);
  return true;
}

// ---- batch thread pool ----
struct BatchTask {
  const Pack* pack;
  const int32_t* vids;      // (batch,)
  const int32_t* indices;   // (batch, frames) row-major
  int batch, frames, out_h, out_w;
  uint8_t* out;             // (batch, frames, out_h, out_w, 3)
  // work queue
  pthread_mutex_t mu;
  int next;                 // next (clip) index
  int errors;
};

void* BatchWorker(void* arg) {
  BatchTask* t = static_cast<BatchTask*>(arg);
  const size_t frame_bytes = size_t(t->out_h) * t->out_w * 3;
  while (true) {
    pthread_mutex_lock(&t->mu);
    int i = t->next++;
    pthread_mutex_unlock(&t->mu);
    if (i >= t->batch) break;
    uint8_t* clip_out = t->out + size_t(i) * t->frames * frame_bytes;
    int vid = t->vids[i];
    // frames within a clip often repeat (wraparound padding) — cache last
    int last_idx = -1;
    for (int f = 0; f < t->frames; ++f) {
      int idx = t->indices[size_t(i) * t->frames + f];
      uint8_t* dst = clip_out + size_t(f) * frame_bytes;
      if (idx == last_idx && f > 0) {
        std::memcpy(dst, dst - frame_bytes, frame_bytes);
        continue;
      }
      if (!ReadFrame(t->pack, vid, idx, t->out_h, t->out_w, dst)) {
        pthread_mutex_lock(&t->mu);
        t->errors++;
        pthread_mutex_unlock(&t->mu);
        std::memset(dst, 0, frame_bytes);
      }
      last_idx = idx;
    }
  }
  return nullptr;
}

// ---- generic blob decode pool (LMDB / frame-dir ingest) ----
struct BlobTask {
  const uint8_t* const* blobs;  // (n,) pointers
  const size_t* lens;           // (n,)
  int n, out_h, out_w;
  uint8_t* out;                 // (n, out_h, out_w, 3)
  pthread_mutex_t mu;
  int next;
  int errors;
};

void* BlobWorker(void* arg) {
  BlobTask* t = static_cast<BlobTask*>(arg);
  const size_t frame_bytes = size_t(t->out_h) * t->out_w * 3;
  std::vector<uint8_t> rgb;
  while (true) {
    pthread_mutex_lock(&t->mu);
    int i = t->next++;
    pthread_mutex_unlock(&t->mu);
    if (i >= t->n) break;
    uint8_t* dst = t->out + size_t(i) * frame_bytes;
    int w = 0, h = 0;
    if (DecodeJpeg(t->blobs[i], t->lens[i], &rgb, &w, &h)) {
      ResizeBilinear(rgb.data(), w, h, dst, t->out_w, t->out_h);
    } else {
      pthread_mutex_lock(&t->mu);
      t->errors++;
      pthread_mutex_unlock(&t->mu);
      std::memset(dst, 0, frame_bytes);
    }
  }
  return nullptr;
}

}  // namespace

extern "C" {

// 1 when the JPEG decode is compiled in, else 0.
int cstp_has_jpeg() { return CSTP_HAVE_JPEG; }

// Decode n independent JPEG blobs into (n, out_h, out_w, 3) u8 with the
// libjpeg pool — serves the reference-LMDB (msgpack'd JPEG lists) and
// frame-dir ingest paths, which otherwise decode via PIL in Python.
// Returns #failed blobs; failures are zero-filled.
int cstp_decode_blobs(const uint8_t* const* blobs, const size_t* lens, int n,
                      int out_h, int out_w, uint8_t* out, int n_threads) {
  BlobTask task;
  task.blobs = blobs;
  task.lens = lens;
  task.n = n;
  task.out_h = out_h;
  task.out_w = out_w;
  task.out = out;
  pthread_mutex_init(&task.mu, nullptr);
  task.next = 0;
  task.errors = 0;
  int nt = n_threads < 1 ? 1 : (n_threads > n ? n : n_threads);
  std::vector<pthread_t> threads(nt);
  for (int i = 0; i < nt; ++i)
    pthread_create(&threads[i], nullptr, BlobWorker, &task);
  for (int i = 0; i < nt; ++i) pthread_join(threads[i], nullptr);
  pthread_mutex_destroy(&task.mu);
  return task.errors;
}

void* cstpack_open(const char* path) {
  Pack* p = new Pack();
  p->fd = open(path, O_RDONLY);
  if (p->fd < 0) {
    delete p;
    return nullptr;
  }
  struct stat st;
  fstat(p->fd, &st);
  p->size = size_t(st.st_size);
  p->base = static_cast<const uint8_t*>(
      mmap(nullptr, p->size, PROT_READ, MAP_SHARED, p->fd, 0));
  if (p->base == MAP_FAILED) {
    close(p->fd);
    delete p;
    return nullptr;
  }
  madvise(const_cast<uint8_t*>(p->base), p->size, MADV_RANDOM);
  const uint8_t* cur = p->base;
  if (std::memcmp(cur, "CSTP", 4) != 0) {
    cstpack_close_helper:
    munmap(const_cast<uint8_t*>(p->base), p->size);
    close(p->fd);
    delete p;
    return nullptr;
  }
  cur += 4;
  uint32_t version = ReadLE<uint32_t>(cur);
  uint64_t n_videos = ReadLE<uint64_t>(cur);
  uint64_t index_offset = ReadLE<uint64_t>(cur);
  if (version != 1 || index_offset >= p->size) goto cstpack_close_helper;
  cur = p->base + index_offset;
  p->index.reserve(n_videos);
  for (uint64_t i = 0; i < n_videos; ++i) {
    VideoIndex v;
    v.label = ReadLE<int32_t>(cur);
    v.nframes = ReadLE<int32_t>(cur);
    v.codec = ReadLE<uint8_t>(cur);
    v.raw_h = ReadLE<uint16_t>(cur);
    v.raw_w = ReadLE<uint16_t>(cur);
    uint16_t plen = ReadLE<uint16_t>(cur);
    v.path.assign(reinterpret_cast<const char*>(cur), plen);
    cur += plen;
    v.offsets = reinterpret_cast<const uint64_t*>(cur);
    cur += sizeof(uint64_t) * (v.nframes + 1);
    p->index.push_back(std::move(v));
  }
  return p;
}

int cstpack_num_videos(void* handle) {
  return int(static_cast<Pack*>(handle)->index.size());
}

// The number of videos stored as JPEG frames (codec 0).
int cstpack_jpeg_videos(void* handle) {
  int n = 0;
  for (const VideoIndex& v : static_cast<Pack*>(handle)->index)
    n += v.codec == kCodecJpeg;
  return n;
}

void cstpack_meta(void* handle, int vid, int* nframes, int* label) {
  const VideoIndex& v = static_cast<Pack*>(handle)->index[vid];
  *nframes = v.nframes;
  *label = v.label;
}

// Fill out (batch, frames, out_h, out_w, 3) u8. Returns #frame errors.
int cstpack_read_batch(void* handle, const int32_t* vids,
                       const int32_t* indices, int batch, int frames,
                       int out_h, int out_w, uint8_t* out, int n_threads) {
  BatchTask task;
  task.pack = static_cast<Pack*>(handle);
  task.vids = vids;
  task.indices = indices;
  task.batch = batch;
  task.frames = frames;
  task.out_h = out_h;
  task.out_w = out_w;
  task.out = out;
  pthread_mutex_init(&task.mu, nullptr);
  task.next = 0;
  task.errors = 0;
  int nt = n_threads < 1 ? 1 : (n_threads > batch ? batch : n_threads);
  std::vector<pthread_t> threads(nt);
  for (int i = 0; i < nt; ++i)
    pthread_create(&threads[i], nullptr, BatchWorker, &task);
  for (int i = 0; i < nt; ++i) pthread_join(threads[i], nullptr);
  pthread_mutex_destroy(&task.mu);
  return task.errors;
}

void cstpack_close(void* handle) {
  Pack* p = static_cast<Pack*>(handle);
  if (p->base && p->base != MAP_FAILED)
    munmap(const_cast<uint8_t*>(p->base), p->size);
  if (p->fd >= 0) close(p->fd);
  delete p;
}

}  // extern "C"
