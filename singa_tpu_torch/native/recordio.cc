// Record IO with threaded prefetch — the native data-plane component.
//
// Reference parity: SINGA's C++ IO stack (src/io/binfile_writer.cc,
// binfile_reader.cc: length-framed key/value records; SURVEY.md §2.9) and
// the multiprocess prefetch in python/singa/data.py. TPU-native rationale:
// the chip stalls when the host input pipeline can't keep up, so record
// reads run on a C++ thread that holds no GIL, prefetching into a bounded
// queue the Python side drains via ctypes.
//
// File format (fresh design, not the reference's):
//   header:  8 bytes  "STPURIO1"
//   record:  u32 keylen | key bytes | u64 vallen | val bytes | u32 crc32
// crc32 covers the value bytes (IEEE polynomial, same table as zlib).

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr char kMagic[9] = "STPURIO1";

uint32_t crc_table[256];
bool crc_init_done = false;

void crc_init() {
  if (crc_init_done) return;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k)
      c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
  crc_init_done = true;
}

uint32_t crc32(const char* data, uint64_t n) {
  crc_init();
  uint32_t c = 0xFFFFFFFFu;
  for (uint64_t i = 0; i < n; ++i)
    c = crc_table[(c ^ static_cast<uint8_t>(data[i])) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct Record {
  std::string key;
  std::string val;
};

struct Writer {
  FILE* f = nullptr;
};

struct Reader {
  FILE* f = nullptr;
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_put, cv_get;
  std::deque<Record> queue;
  size_t depth = 8;
  bool eof = false;
  bool stop = false;
  bool corrupt = false;
  Record current;  // last record handed to the caller

  void run() {
    char magic[8];
    if (fread(magic, 1, 8, f) != 8 || memcmp(magic, kMagic, 8) != 0) {
      std::lock_guard<std::mutex> g(mu);
      corrupt = true;
      eof = true;
      cv_get.notify_all();
      return;
    }
    // File size bounds every length field: a corrupt/truncated record with
    // a garbage length must surface as corrupt=true (OSError in Python),
    // not throw bad_alloc in this thread and std::terminate the process.
    long pos = ftell(f);
    fseek(f, 0, SEEK_END);
    const uint64_t fsize = (uint64_t)ftell(f);
    fseek(f, pos, SEEK_SET);
    while (true) {
      uint32_t klen;
      if (fread(&klen, 4, 1, f) != 1) break;  // clean EOF
      uint64_t remaining = fsize - (uint64_t)ftell(f);
      Record r;
      uint64_t vlen = 0;
      uint32_t crc;
      bool bad = (uint64_t)klen > remaining;
      if (!bad) {
        r.key.resize(klen);
        bad = (klen && fread(&r.key[0], 1, klen, f) != klen) ||
              fread(&vlen, 8, 1, f) != 1;
      }
      if (!bad) {
        remaining = fsize - (uint64_t)ftell(f);
        bad = vlen > remaining;
      }
      if (!bad) {
        r.val.resize(vlen);
        bad = (vlen && fread(&r.val[0], 1, vlen, f) != vlen) ||
              fread(&crc, 4, 1, f) != 1 ||
              crc32(r.val.data(), vlen) != crc;
      }
      std::unique_lock<std::mutex> lk(mu);
      if (bad) {
        corrupt = true;
        break;
      }
      cv_put.wait(lk, [&] { return queue.size() < depth || stop; });
      if (stop) break;
      queue.push_back(std::move(r));
      cv_get.notify_one();
    }
    std::lock_guard<std::mutex> g(mu);
    eof = true;
    cv_get.notify_all();
  }
};

}  // namespace

extern "C" {

void* rio_writer_open(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  if (fwrite(kMagic, 1, 8, f) != 8) {
    fclose(f);
    return nullptr;
  }
  Writer* w = new Writer;
  w->f = f;
  return w;
}

int rio_writer_write(void* h, const char* key, uint32_t klen,
                     const char* val, uint64_t vlen) {
  Writer* w = static_cast<Writer*>(h);
  uint32_t crc = crc32(val, vlen);
  if (fwrite(&klen, 4, 1, w->f) != 1) return -1;
  if (klen && fwrite(key, 1, klen, w->f) != klen) return -1;
  if (fwrite(&vlen, 8, 1, w->f) != 1) return -1;
  if (vlen && fwrite(val, 1, vlen, w->f) != vlen) return -1;
  if (fwrite(&crc, 4, 1, w->f) != 1) return -1;
  return 0;
}

int rio_writer_close(void* h) {
  Writer* w = static_cast<Writer*>(h);
  int rc = fclose(w->f);
  delete w;
  return rc;
}

void* rio_reader_open(const char* path, int depth) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  Reader* r = new Reader;
  r->f = f;
  if (depth > 0) r->depth = static_cast<size_t>(depth);
  r->worker = std::thread([r] { r->run(); });
  return r;
}

// Returns 1 on record, 0 on EOF, -1 on corruption. Pointers are valid
// until the next call on the same reader.
int rio_reader_next(void* h, const char** key, uint32_t* klen,
                    const char** val, uint64_t* vlen) {
  Reader* r = static_cast<Reader*>(h);
  std::unique_lock<std::mutex> lk(r->mu);
  r->cv_get.wait(lk, [&] { return !r->queue.empty() || r->eof; });
  if (r->queue.empty()) return r->corrupt ? -1 : 0;
  r->current = std::move(r->queue.front());
  r->queue.pop_front();
  r->cv_put.notify_one();
  *key = r->current.key.data();
  *klen = static_cast<uint32_t>(r->current.key.size());
  *val = r->current.val.data();
  *vlen = r->current.val.size();
  return 1;
}

void rio_reader_close(void* h) {
  Reader* r = static_cast<Reader*>(h);
  {
    std::lock_guard<std::mutex> g(r->mu);
    r->stop = true;
    r->cv_put.notify_all();
  }
  if (r->worker.joinable()) r->worker.join();
  fclose(r->f);
  delete r;
}

}  // extern "C"
