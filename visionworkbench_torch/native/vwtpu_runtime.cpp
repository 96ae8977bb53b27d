// vwtpu_runtime: native host-side runtime of visionworkbench_torch (the
// port's own copy of native/vwtpu_runtime.cpp, plus vwtpu_writer_abort and
// a window on tile indices in vwtpu_writer_submit).
//
// The reference implements its execution substrate in C++ — thread pools
// (src/vw/Core/ThreadPool.h), the ordered block writer with a bounded
// in-flight window (src/vw/Image/ImageIO.h:116-267), and the LRU resource
// cache (src/vw/Core/Cache.h). This library provides the same substrate for
// the framework's host side: a multithreaded ordered tiled-TIFF writer
// (releases the Python GIL entirely — tile encode + file IO run on C++
// threads) and a byte-LRU cache for regenerable tiles.
//
// C ABI only (consumed via ctypes). Built at first use by
// visionworkbench_torch/native/__init__.py with
// g++ -O3 -shared -fPIC -std=c++17 -pthread.

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <list>
#include <map>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Minimal tiled TIFF writer (little-endian classic TIFF, uncompressed),
// matching the layout of the Python codec in fileio/tiff.py.
// ---------------------------------------------------------------------------

namespace {

struct IfdEntry {
  uint16_t tag;
  uint16_t type;
  uint32_t count;
  std::vector<uint8_t> data;  // packed payload
};

void pack16(std::vector<uint8_t>& v, uint16_t x) {
  v.push_back(x & 0xff);
  v.push_back((x >> 8) & 0xff);
}
void pack32(std::vector<uint8_t>& v, uint32_t x) {
  for (int i = 0; i < 4; i++) v.push_back((x >> (8 * i)) & 0xff);
}

struct TiffWriter {
  FILE* f = nullptr;
  int64_t h = 0, w = 0, bands = 1;
  int dtype_code = 0;  // 0=u8 1=u16 2=i16 3=i32 4=f32 5=f64
  int tile = 256;
  int64_t ntx = 0, nty = 0;
  size_t bytes_per_sample = 4;
  std::vector<uint32_t> offsets, counts;

  size_t tile_bytes() const {
    return (size_t)tile * tile * bands * bytes_per_sample;
  }
};

size_t dtype_size(int code) {
  switch (code) {
    case 0: return 1;
    case 1: case 2: return 2;
    case 3: case 4: return 4;
    case 5: return 8;
  }
  return 4;
}
int dtype_bits(int code) { return (int)dtype_size(code) * 8; }
int dtype_format(int code) {  // TIFF SampleFormat
  switch (code) {
    case 0: case 1: return 1;  // unsigned
    case 2: case 3: return 2;  // signed
    case 4: case 5: return 3;  // float
  }
  return 1;
}

void add_entry(std::vector<IfdEntry>& ifd, uint16_t tag, uint16_t type,
               const std::vector<uint32_t>& values) {
  IfdEntry e{tag, type, (uint32_t)values.size(), {}};
  for (uint32_t v : values) {
    if (type == 3) pack16(e.data, (uint16_t)v);
    else pack32(e.data, v);
  }
  ifd.push_back(e);
}

void write_ifd(TiffWriter* tw) {
  std::vector<IfdEntry> ifd;
  add_entry(ifd, 256, 4, {(uint32_t)tw->w});
  add_entry(ifd, 257, 4, {(uint32_t)tw->h});
  {
    std::vector<uint32_t> bps(tw->bands, dtype_bits(tw->dtype_code));
    add_entry(ifd, 258, 3, bps);
  }
  add_entry(ifd, 259, 3, {1});
  add_entry(ifd, 262, 3, {tw->bands >= 3 ? 2u : 1u});
  add_entry(ifd, 277, 3, {(uint32_t)tw->bands});
  add_entry(ifd, 284, 3, {1});
  {
    std::vector<uint32_t> fmt(tw->bands, dtype_format(tw->dtype_code));
    add_entry(ifd, 339, 3, fmt);
  }
  add_entry(ifd, 322, 3, {(uint32_t)tw->tile});
  add_entry(ifd, 323, 3, {(uint32_t)tw->tile});
  add_entry(ifd, 324, 4, std::vector<uint32_t>(tw->offsets.begin(),
                                               tw->offsets.end()));
  add_entry(ifd, 325, 4, std::vector<uint32_t>(tw->counts.begin(),
                                               tw->counts.end()));
  std::sort(ifd.begin(), ifd.end(),
            [](const IfdEntry& a, const IfdEntry& b) { return a.tag < b.tag; });

  long pos = ftell(tw->f);
  if (pos % 2) {
    fputc(0, tw->f);
    pos++;
  }
  uint32_t ifd_offset = (uint32_t)pos;
  size_t n = ifd.size();
  uint32_t ext_offset = ifd_offset + 2 + (uint32_t)n * 12 + 4;
  std::vector<uint8_t> body, ext;
  pack16(body, (uint16_t)n);
  for (auto& e : ifd) {
    pack16(body, e.tag);
    pack16(body, e.type);
    pack32(body, e.count);
    if (e.data.size() <= 4) {
      std::vector<uint8_t> d = e.data;
      d.resize(4, 0);
      body.insert(body.end(), d.begin(), d.end());
    } else {
      pack32(body, ext_offset + (uint32_t)ext.size());
      ext.insert(ext.end(), e.data.begin(), e.data.end());
      if (ext.size() % 2) ext.push_back(0);
    }
  }
  pack32(body, 0);
  fwrite(body.data(), 1, body.size(), tw->f);
  fwrite(ext.data(), 1, ext.size(), tw->f);
  fseek(tw->f, 4, SEEK_SET);
  uint8_t off[4] = {(uint8_t)(ifd_offset & 0xff),
                    (uint8_t)((ifd_offset >> 8) & 0xff),
                    (uint8_t)((ifd_offset >> 16) & 0xff),
                    (uint8_t)((ifd_offset >> 24) & 0xff)};
  fwrite(off, 1, 4, tw->f);
}

// ---------------------------------------------------------------------------
// Ordered async writer: tiles submitted in any order, committed to disk in
// raster order by a writer thread; a bounded window provides backpressure
// (ref CountingSemaphore + OrderedWorkQueue, ImageIO.h:116-267).
// ---------------------------------------------------------------------------

struct OrderedWriter {
  TiffWriter tiff;
  std::mutex mu;
  std::condition_variable cv_space, cv_data;
  std::map<int64_t, std::vector<uint8_t>> pending;  // tile idx -> data
  int64_t next_to_write = 0;
  int64_t total_tiles = 0;
  int window = 21;
  bool done = false;
  bool failed = false;
  bool writer_exited = false;
  std::thread writer;

  void mark_exited() {
    std::lock_guard<std::mutex> lk(mu);
    writer_exited = true;
    cv_space.notify_all();
  }

  void writer_loop() {
    while (true) {
      std::vector<uint8_t> data;
      int64_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_data.wait(lk, [&] {
          return failed || done ||
                 (!pending.empty() && pending.begin()->first == next_to_write);
        });
        if (failed) break;
        if (pending.empty() || pending.begin()->first != next_to_write) {
          if (done) break;
          continue;
        }
        idx = pending.begin()->first;
        data = std::move(pending.begin()->second);
        pending.erase(pending.begin());
      }
      long off = ftell(tiff.f);
      size_t written = fwrite(data.data(), 1, data.size(), tiff.f);
      {
        std::lock_guard<std::mutex> lk(mu);
        if (written != data.size()) {
          failed = true;
        } else {
          tiff.offsets[idx] = (uint32_t)off;
          tiff.counts[idx] = (uint32_t)data.size();
          next_to_write = idx + 1;
        }
        cv_space.notify_all();
        cv_data.notify_all();
      }
      if (failed) break;
    }
    mark_exited();
  }
};

}  // namespace

void* vwtpu_writer_create(const char* path, int64_t h, int64_t w,
                          int64_t bands, int dtype_code, int tile,
                          int window) {
  auto* ow = new OrderedWriter();
  ow->tiff.h = h;
  ow->tiff.w = w;
  ow->tiff.bands = bands;
  ow->tiff.dtype_code = dtype_code;
  ow->tiff.tile = tile;
  ow->tiff.bytes_per_sample = dtype_size(dtype_code);
  ow->tiff.ntx = (w + tile - 1) / tile;
  ow->tiff.nty = (h + tile - 1) / tile;
  ow->total_tiles = ow->tiff.ntx * ow->tiff.nty;
  ow->tiff.offsets.assign(ow->total_tiles, 0);
  ow->tiff.counts.assign(ow->total_tiles, 0);
  ow->window = window > 0 ? window : 21;
  ow->tiff.f = fopen(path, "wb");
  if (!ow->tiff.f) {
    delete ow;
    return nullptr;
  }
  const uint8_t header[8] = {'I', 'I', 42, 0, 0, 0, 0, 0};
  fwrite(header, 1, 8, ow->tiff.f);
  ow->writer = std::thread([ow] { ow->writer_loop(); });
  return ow;
}

// Submit one full tile (tile*tile*bands elements, row-major, already padded).
// Blocks while the tile lies `window` or more tiles past the next tile to
// write, so at most `window` tiles wait and the next one is always admitted.
// (A bound on the count of waiting tiles alone deadlocks: `window` later
// tiles can fill it while the next one's submit waits for room.)
// Returns 0 on success.
int vwtpu_writer_submit(void* handle, int64_t tile_index, const void* data) {
  auto* ow = static_cast<OrderedWriter*>(handle);
  size_t nbytes = ow->tiff.tile_bytes();
  std::vector<uint8_t> buf((const uint8_t*)data,
                           (const uint8_t*)data + nbytes);
  {
    std::unique_lock<std::mutex> lk(ow->mu);
    ow->cv_space.wait(lk, [&] {
      return ow->failed || tile_index < ow->next_to_write + ow->window;
    });
    if (ow->failed) return 1;
    ow->pending.emplace(tile_index, std::move(buf));
    ow->cv_data.notify_all();
  }
  return 0;
}

// Fail the write: the writer thread stops and every submit blocked on a full
// window returns 1, so a caller whose tile function raised does not wait for
// a tile that will never come. close() then returns 1.
void vwtpu_writer_abort(void* handle) {
  auto* ow = static_cast<OrderedWriter*>(handle);
  std::lock_guard<std::mutex> lk(ow->mu);
  ow->failed = true;
  ow->cv_space.notify_all();
  ow->cv_data.notify_all();
}

// Finish: waits for all tiles, writes the IFD, closes. Returns 0 on success.
int vwtpu_writer_close(void* handle) {
  auto* ow = static_cast<OrderedWriter*>(handle);
  {
    std::unique_lock<std::mutex> lk(ow->mu);
    ow->done = true;
    ow->cv_data.notify_all();
    ow->cv_space.wait(lk, [&] { return ow->writer_exited; });
  }
  ow->writer.join();
  // Incomplete submission (next_to_write short of total) is a failure too.
  int rc = (ow->failed || ow->next_to_write < ow->total_tiles) ? 1 : 0;
  if (rc == 0) {
    write_ifd(&ow->tiff);
  }
  fclose(ow->tiff.f);
  delete ow;
  return rc;
}

// ---------------------------------------------------------------------------
// Byte-LRU cache (ref vw::Cache, Cache.h:105-295): keyed blobs with a byte
// budget, LRU eviction, hit/miss counters. Thread-safe.
// ---------------------------------------------------------------------------

namespace {

struct LruCache {
  std::mutex mu;
  size_t budget = 0;
  size_t used = 0;
  uint64_t hits = 0, misses = 0, evictions = 0;
  std::list<std::pair<std::string, std::vector<uint8_t>>> order;  // MRU front
  std::unordered_map<std::string,
                     std::list<std::pair<std::string,
                                         std::vector<uint8_t>>>::iterator>
      index;
};

}  // namespace

void* vwtpu_cache_create(int64_t budget_bytes) {
  auto* c = new LruCache();
  c->budget = (size_t)budget_bytes;
  return c;
}

void vwtpu_cache_put(void* handle, const char* key, const void* data,
                     int64_t nbytes) {
  auto* c = static_cast<LruCache*>(handle);
  std::lock_guard<std::mutex> lk(c->mu);
  auto it = c->index.find(key);
  if (it != c->index.end()) {
    c->used -= it->second->second.size();
    c->order.erase(it->second);
    c->index.erase(it);
  }
  c->order.emplace_front(key, std::vector<uint8_t>(
                                  (const uint8_t*)data,
                                  (const uint8_t*)data + nbytes));
  c->index[key] = c->order.begin();
  c->used += (size_t)nbytes;
  while (c->used > c->budget && c->order.size() > 1) {
    auto& back = c->order.back();
    c->used -= back.second.size();
    c->index.erase(back.first);
    c->order.pop_back();
    c->evictions++;
  }
}

// Returns size of the value, copying up to bufsize bytes into buf.
// Returns -1 on miss.
int64_t vwtpu_cache_get(void* handle, const char* key, void* buf,
                        int64_t bufsize) {
  auto* c = static_cast<LruCache*>(handle);
  std::lock_guard<std::mutex> lk(c->mu);
  auto it = c->index.find(key);
  if (it == c->index.end()) {
    c->misses++;
    return -1;
  }
  c->hits++;
  c->order.splice(c->order.begin(), c->order, it->second);
  auto& v = it->second->second;
  int64_t n = (int64_t)v.size();
  if (buf && bufsize >= n) std::memcpy(buf, v.data(), (size_t)n);
  return n;
}

void vwtpu_cache_stats(void* handle, int64_t* out4) {
  auto* c = static_cast<LruCache*>(handle);
  std::lock_guard<std::mutex> lk(c->mu);
  out4[0] = (int64_t)c->used;
  out4[1] = (int64_t)c->hits;
  out4[2] = (int64_t)c->misses;
  out4[3] = (int64_t)c->evictions;
}

void vwtpu_cache_destroy(void* handle) {
  delete static_cast<LruCache*>(handle);
}

int vwtpu_runtime_version() { return 1; }

}  // extern "C"
