// Native log-structured KV engine for the Store actor.
//
// The reference's store crate wraps rocksdb behind a single-writer actor
// (store/src/lib.rs:15-92). Here the data plane — hash index, append-only
// length-prefixed log, crash-safe replay that ignores a torn tail — is
// C++; the Python actor (hotstuff_tpu_torch/store/store.py) keeps the
// channel protocol and notify_read obligations and calls in via ctypes.
// The port's copy of the reference's engine (native/store.cpp): the same
// log format, so either engine replays the other's log.
//
// Log record: <u32 klen><u32 vlen><key><value>, little-endian.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include <unistd.h>

namespace {

struct Store {
  std::unordered_map<std::string, std::string> index;
  FILE *log = nullptr;
  std::string path;
  bool fsync_writes = false;
};

// Replays the log into the index and returns the byte offset of the last
// complete record, so the caller can truncate a torn tail before appending
// (appending after torn bytes would make every later record unreachable on
// the next replay).
long replay(Store *s, const char *path) {
  FILE *f = fopen(path, "rb");
  if (!f) return 0;
  std::vector<uint8_t> hdr(8);
  std::string key, val;
  long good = 0;
  for (;;) {
    if (fread(hdr.data(), 1, 8, f) != 8) break;
    uint32_t klen, vlen;
    memcpy(&klen, hdr.data(), 4);
    memcpy(&vlen, hdr.data() + 4, 4);
    // guard against a corrupt header at the torn tail
    if (klen > (1u << 20) || vlen > (1u << 28)) break;
    key.resize(klen);
    val.resize(vlen);
    if (klen && fread(&key[0], 1, klen, f) != klen) break;
    if (vlen && fread(&val[0], 1, vlen, f) != vlen) break;
    s->index[key] = val;
    good = ftell(f);
  }
  fclose(f);
  return good;
}

bool write_record(FILE *f, const std::string &k, const std::string &v) {
  uint32_t kl = (uint32_t)k.size(), vl = (uint32_t)v.size();
  if (fwrite(&kl, 4, 1, f) != 1) return false;
  if (fwrite(&vl, 4, 1, f) != 1) return false;
  if (kl && fwrite(k.data(), 1, kl, f) != kl) return false;
  if (vl && fwrite(v.data(), 1, vl, f) != vl) return false;
  return true;
}

}  // namespace

extern "C" {

void *hs_store_open(const char *path, int fsync_writes) {
  auto *s = new Store;
  s->fsync_writes = fsync_writes != 0;
  if (path && path[0]) {
    s->path = path;
    long good = replay(s, path);
    if (truncate(path, good) != 0 && good > 0) {
      // fall through: append still works, replay will re-stop at `good`
    }
    s->log = fopen(path, "ab");
    if (!s->log) {
      delete s;
      return nullptr;
    }
  }
  return s;
}

// Rewrites the log with live keys only (dead versions dropped), atomically
// via rename. Returns new log size in bytes, or -1 on failure. The role
// rocksdb's background compaction plays in the reference (store/src/lib.rs).
int64_t hs_store_compact(void *sp) {
  auto *s = static_cast<Store *>(sp);
  if (!s->log) return 0;
  std::string tmp = s->path + ".compact";
  FILE *out = fopen(tmp.c_str(), "wb");
  if (!out) return -1;
  for (const auto &kv : s->index) {
    if (!write_record(out, kv.first, kv.second)) {
      fclose(out);
      remove(tmp.c_str());
      return -1;
    }
  }
  if (fflush(out) != 0 || fsync(fileno(out)) != 0) {
    fclose(out);
    remove(tmp.c_str());
    return -1;
  }
  fclose(out);
  fclose(s->log);
  if (rename(tmp.c_str(), s->path.c_str()) != 0) {
    s->log = fopen(s->path.c_str(), "ab");
    return -1;
  }
  s->log = fopen(s->path.c_str(), "ab");
  if (!s->log) return -1;
  long sz = ftell(s->log);
  return (int64_t)sz;
}

int hs_store_write(void *sp, const uint8_t *k, int64_t klen, const uint8_t *v,
                   int64_t vlen) {
  auto *s = static_cast<Store *>(sp);
  s->index[std::string((const char *)k, klen)] =
      std::string((const char *)v, vlen);
  if (s->log) {
    uint32_t kl = (uint32_t)klen, vl = (uint32_t)vlen;
    if (fwrite(&kl, 4, 1, s->log) != 1) return -1;
    if (fwrite(&vl, 4, 1, s->log) != 1) return -1;
    if (klen && fwrite(k, 1, klen, s->log) != (size_t)klen) return -1;
    if (vlen && fwrite(v, 1, vlen, s->log) != (size_t)vlen) return -1;
    if (fflush(s->log) != 0) return -1;
  }
  return 0;
}

// Returns value length and malloc'd buffer in *out (caller frees via
// hs_free), or -1 if absent.
int64_t hs_store_read(void *sp, const uint8_t *k, int64_t klen,
                      uint8_t **out) {
  auto *s = static_cast<Store *>(sp);
  auto it = s->index.find(std::string((const char *)k, klen));
  if (it == s->index.end()) return -1;
  *out = (uint8_t *)malloc(it->second.size());
  memcpy(*out, it->second.data(), it->second.size());
  return (int64_t)it->second.size();
}

void hs_store_close(void *sp) {
  auto *s = static_cast<Store *>(sp);
  if (s->log) fclose(s->log);
  delete s;
}

void hs_free(void *p) { free(p); }

}  // extern "C"
