// Binfile tensor kv-store — the native checkpoint component.
//
// Reference parity: SINGA's Snapshot (src/io/snapshot.cc) writes a binfile
// of TensorProto records through BinFileWriter (src/io/binfile_writer.cc:
// length-framed key/value blocks). TPU-native redesign: raw host buffers
// (numpy/jax arrays are already contiguous) framed with explicit
// dtype/shape metadata and CRC-checked values — no protobuf on the write
// path — and the disk write happens on a background C++ thread holding no
// GIL, so CRC+disk IO of record N overlaps marshalling of record N+1
// (pending copies bounded by kQueueCap).
//
// File format:
//   header:  8 bytes "STPUSNP1"
//   record:  u32 keylen | key | u8 dtypelen | dtype | u8 ndim |
//            u64 dims[ndim] | u64 nbytes | value bytes | u32 crc32(value)
//
// C ABI (ctypes-bound in native/__init__.py):
//   snp_writer_open/write/close   — write() enqueues a copy; a flusher
//                                   thread drains to disk; close() joins.
//   snp_reader_open/next/close    — sequential scan; out-pointers remain
//                                   valid until the next call on the same
//                                   reader.

#include <array>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#ifndef _WIN32
#include <unistd.h>
#endif

namespace {

constexpr char kMagic[9] = "STPUSNP1";
constexpr uint64_t kMaxKeyLen = 1ull << 20;   // corrupt-frame guards: keys
constexpr uint64_t kMaxValLen = 1ull << 34;   // <=1 MB, values <=16 GB
constexpr uint64_t kQueueCap = 256ull << 20;  // pending-bytes bound (256 MB)

const uint32_t* crc_table() {
  // magic-static: thread-safe one-time init even with concurrent flushers
  static const std::array<uint32_t, 256> table = [] {
    std::array<uint32_t, 256> t{};
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
    return t;
  }();
  return table.data();
}

uint32_t crc32(const char* data, uint64_t n) {
  const uint32_t* tab = crc_table();
  uint32_t c = 0xFFFFFFFFu;
  for (uint64_t i = 0; i < n; ++i)
    c = tab[(c ^ static_cast<uint8_t>(data[i])) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct Entry {
  std::string key;
  std::string dtype;
  std::vector<uint64_t> dims;
  std::string val;
};

struct Writer {
  FILE* f = nullptr;
  std::thread flusher;
  std::mutex mu;
  std::condition_variable cv;
  std::deque<Entry> queue;
  uint64_t queued_bytes = 0;  // bounded by kQueueCap: write() blocks when
                              // full, capping host memory at one copy of
                              // at most kQueueCap pending value bytes
  bool closing = false;
  bool io_error = false;

  void run() {
    for (;;) {
      Entry e;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return !queue.empty() || closing; });
        if (queue.empty()) return;
        e = std::move(queue.front());
        queue.pop_front();
        queued_bytes -= e.val.size();
      }
      if (!write_entry(e)) {
        std::lock_guard<std::mutex> lk(mu);
        io_error = true;
      }
      cv.notify_all();
    }
  }

  bool write_entry(const Entry& e) {
    uint32_t klen = static_cast<uint32_t>(e.key.size());
    uint8_t dlen = static_cast<uint8_t>(e.dtype.size());
    uint8_t ndim = static_cast<uint8_t>(e.dims.size());
    uint64_t nbytes = e.val.size();
    uint32_t crc = crc32(e.val.data(), nbytes);
    if (fwrite(&klen, 4, 1, f) != 1) return false;
    if (klen && fwrite(e.key.data(), 1, klen, f) != klen) return false;
    if (fwrite(&dlen, 1, 1, f) != 1) return false;
    if (dlen && fwrite(e.dtype.data(), 1, dlen, f) != dlen) return false;
    if (fwrite(&ndim, 1, 1, f) != 1) return false;
    for (uint64_t d : e.dims)
      if (fwrite(&d, 8, 1, f) != 1) return false;
    if (fwrite(&nbytes, 8, 1, f) != 1) return false;
    if (nbytes && fwrite(e.val.data(), 1, nbytes, f) != nbytes) return false;
    if (fwrite(&crc, 4, 1, f) != 1) return false;
    return true;
  }
};

struct Reader {
  FILE* f = nullptr;
  Entry cur;  // storage backing the out-pointers of the last next()
};

}  // namespace

extern "C" {

void* snp_writer_open(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  if (fwrite(kMagic, 1, 8, f) != 8) {
    fclose(f);
    return nullptr;
  }
  Writer* w = new Writer;
  w->f = f;
  w->flusher = std::thread([w] { w->run(); });
  return w;
}

// Enqueue one tensor; copies all buffers, so the caller may free/donate
// them immediately. Blocks while more than kQueueCap value bytes are
// pending (ctypes releases the GIL around this call). Returns 0 on
// success, -1 on a prior flush error.
int snp_writer_write(void* h, const char* key, const char* dtype,
                     uint8_t ndim, const uint64_t* dims, const char* data,
                     uint64_t nbytes) {
  Writer* w = static_cast<Writer*>(h);
  // mirror the reader's frame guards: anything accepted here must be
  // readable back
  if ((key && strlen(key) > kMaxKeyLen) || nbytes > kMaxValLen) return -1;
  Entry e;
  e.key = key ? key : "";
  e.dtype = dtype ? dtype : "";
  e.dims.assign(dims, dims + ndim);
  e.val.assign(data, data + nbytes);
  std::unique_lock<std::mutex> lk(w->mu);
  w->cv.wait(lk, [&] {
    return w->queued_bytes <= kQueueCap || w->io_error;
  });
  if (w->io_error) return -1;
  w->queued_bytes += e.val.size();
  w->queue.push_back(std::move(e));
  w->cv.notify_all();
  return 0;
}

// Drain, fsync, close. Returns 0 on success, -1 if any write failed.
int snp_writer_close(void* h) {
  Writer* w = static_cast<Writer*>(h);
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->closing = true;
    w->cv.notify_all();
  }
  w->flusher.join();
  int rc = w->io_error ? -1 : 0;
  if (fflush(w->f) != 0) rc = -1;
#ifndef _WIN32
  if (fsync(fileno(w->f)) != 0) rc = -1;  // durable before reporting success
#endif
  if (fclose(w->f) != 0) rc = -1;
  delete w;
  return rc;
}

void* snp_reader_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  char magic[8];
  if (fread(magic, 1, 8, f) != 8 || memcmp(magic, kMagic, 8) != 0) {
    fclose(f);
    return nullptr;
  }
  Reader* r = new Reader;
  r->f = f;
  return r;
}

// Returns 1 with the next record, 0 at EOF, -1 on corruption (bad frame,
// CRC mismatch, or an unallocatable corrupt length — the try/catch keeps
// bad_alloc from escaping the C ABI and aborting the host process).
// Out-pointers are owned by the reader.
int snp_reader_next(void* h, const char** key, const char** dtype,
                    uint8_t* ndim, const uint64_t** dims,
                    const char** data, uint64_t* nbytes) try {
  Reader* r = static_cast<Reader*>(h);
  uint32_t klen;
  size_t got = fread(&klen, 4, 1, r->f);
  if (got != 1) return feof(r->f) ? 0 : -1;
  if (klen > kMaxKeyLen) return -1;
  r->cur.key.resize(klen);
  if (klen && fread(&r->cur.key[0], 1, klen, r->f) != klen) return -1;
  uint8_t dlen;
  if (fread(&dlen, 1, 1, r->f) != 1) return -1;
  r->cur.dtype.resize(dlen);
  if (dlen && fread(&r->cur.dtype[0], 1, dlen, r->f) != dlen) return -1;
  uint8_t nd;
  if (fread(&nd, 1, 1, r->f) != 1) return -1;
  r->cur.dims.resize(nd);
  for (int i = 0; i < nd; ++i)
    if (fread(&r->cur.dims[i], 8, 1, r->f) != 1) return -1;
  uint64_t nb;
  if (fread(&nb, 8, 1, r->f) != 1) return -1;
  if (nb > kMaxValLen) return -1;
  r->cur.val.resize(nb);
  if (nb && fread(&r->cur.val[0], 1, nb, r->f) != nb) return -1;
  uint32_t crc_stored;
  if (fread(&crc_stored, 4, 1, r->f) != 1) return -1;
  if (crc32(r->cur.val.data(), nb) != crc_stored) return -1;
  *key = r->cur.key.c_str();
  *dtype = r->cur.dtype.c_str();
  *ndim = nd;
  *dims = r->cur.dims.data();
  *data = r->cur.val.data();
  *nbytes = nb;
  return 1;
} catch (...) {
  return -1;
}

void snp_reader_close(void* h) {
  Reader* r = static_cast<Reader*>(h);
  fclose(r->f);
  delete r;
}

}  // extern "C"
