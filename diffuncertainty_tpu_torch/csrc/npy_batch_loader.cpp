// Native batch loader: read a batch of .npy files into a caller-provided
// contiguous buffer with a thread pool (a copy of the JAX package's
// native/npy_batch_loader.cpp).
//
// The reference delegates data IO to torch DataLoader worker *processes*
// (fork + pickle + IPC per batch). This loader keeps IO in-process: N reader
// threads parse the npy header, seek to the payload, and read straight into
// the batch slot — no interpreter, no GIL, no serialization. Built with the
// host C++ compiler at first use and bound through ctypes by
// diffuncertainty_tpu_torch/data/native_loader.py, which raises when the
// build, the load or a read fails.
//
// Supported payloads: little-endian float32/float64/uint8/int32/int64 arrays
// in C order (what this framework's preprocessing writes). Outputs are
// converted to the slot dtype (f32 for images, i32 for masks).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NpyInfo {
  char dtype;         // 'f' float, 'i' int, 'u' uint
  int itemsize;
  long long count;    // number of elements
  long payload_off;   // byte offset of the data
  bool fortran;
};

bool parse_npy_header(FILE* f, NpyInfo* info) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  int major = magic[6];
  unsigned int header_len = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return false;
    header_len = b[0] | (b[1] << 8);
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return false;
    header_len = b[0] | (b[1] << 8) | (b[2] << 16) | ((unsigned)b[3] << 24);
  }
  std::string header(header_len, '\0');
  if (fread(&header[0], 1, header_len, f) != header_len) return false;
  info->payload_off = ftell(f);

  // descr
  size_t dp = header.find("'descr'");
  if (dp == std::string::npos) return false;
  size_t q1 = header.find('\'', dp + 7);
  size_t q2 = header.find('\'', q1 + 1);
  std::string descr = header.substr(q1 + 1, q2 - q1 - 1);
  if (descr.size() < 3) return false;
  if (descr[0] == '>') return false;  // big-endian unsupported
  info->dtype = descr[1];
  info->itemsize = atoi(descr.c_str() + 2);

  // fortran_order
  info->fortran = header.find("'fortran_order': True") != std::string::npos;

  // shape -> element count
  size_t sp = header.find("'shape'");
  if (sp == std::string::npos) return false;
  size_t p1 = header.find('(', sp);
  size_t p2 = header.find(')', p1);
  std::string shape = header.substr(p1 + 1, p2 - p1 - 1);
  long long count = 1;
  const char* s = shape.c_str();
  char* end = nullptr;
  bool any = false;
  while (*s) {
    long long v = strtoll(s, &end, 10);
    if (end == s) break;
    count *= v;
    any = true;
    s = end;
    while (*s == ',' || *s == ' ') ++s;
  }
  if (!any) count = 1;
  info->count = count;
  return true;
}

template <typename SRC, typename DST>
bool read_convert(FILE* f, long long count, DST* out) {
  constexpr size_t CHUNK = 1 << 16;
  std::vector<SRC> buf(CHUNK);
  long long done = 0;
  while (done < count) {
    size_t n = (size_t)std::min<long long>(CHUNK, count - done);
    if (fread(buf.data(), sizeof(SRC), n, f) != n) return false;
    for (size_t i = 0; i < n; ++i) out[done + i] = (DST)buf[i];
    done += n;
  }
  return true;
}

// dst_kind: 0 = float32, 1 = int32
int load_one(const char* path, void* dst, long long expect_count, int dst_kind) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  NpyInfo info;
  if (!parse_npy_header(f, &info) || info.fortran) { fclose(f); return 2; }
  if (info.count != expect_count) { fclose(f); return 3; }
  bool ok = false;
  if (dst_kind == 0) {
    float* out = (float*)dst;
    if (info.dtype == 'f' && info.itemsize == 4) {
      ok = fread(out, 4, info.count, f) == (size_t)info.count;
    } else if (info.dtype == 'f' && info.itemsize == 8) {
      ok = read_convert<double, float>(f, info.count, out);
    } else if (info.dtype == 'u' && info.itemsize == 1) {
      ok = read_convert<uint8_t, float>(f, info.count, out);
      if (ok) for (long long i = 0; i < info.count; ++i) out[i] /= 255.0f;
    } else if (info.dtype == 'i' && info.itemsize == 4) {
      ok = read_convert<int32_t, float>(f, info.count, out);
    }
  } else {
    int32_t* out = (int32_t*)dst;
    if (info.dtype == 'i' && info.itemsize == 4) {
      ok = fread(out, 4, info.count, f) == (size_t)info.count;
    } else if (info.dtype == 'i' && info.itemsize == 8) {
      ok = read_convert<int64_t, int32_t>(f, info.count, out);
    } else if (info.dtype == 'u' && info.itemsize == 1) {
      ok = read_convert<uint8_t, int32_t>(f, info.count, out);
    } else if (info.dtype == 'i' && info.itemsize == 1) {
      ok = read_convert<int8_t, int32_t>(f, info.count, out);
    }
  }
  fclose(f);
  return ok ? 0 : 4;
}

}  // namespace

extern "C" {

// Load n files concurrently; paths are NUL-separated. Each file i lands at
// dst + i * slot_elems * elem_size. Returns 0 on success, else 100 + first
// failing index.
int npy_load_batch(const char* paths, int n, void* dst, long long slot_elems,
                   int dst_kind, int num_threads) {
  std::vector<const char*> files(n);
  const char* p = paths;
  for (int i = 0; i < n; ++i) {
    files[i] = p;
    p += strlen(p) + 1;
  }
  std::atomic<int> next(0);
  std::atomic<int> failed(-1);
  int elem_size = dst_kind == 0 ? 4 : 4;
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n || failed.load() >= 0) return;
      char* slot = (char*)dst + (long long)i * slot_elems * elem_size;
      int rc = load_one(files[i], slot, slot_elems, dst_kind);
      if (rc != 0) {
        int expect = -1;
        failed.compare_exchange_strong(expect, i);
      }
    }
  };
  int nt = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  int idx = failed.load();
  return idx >= 0 ? 100 + idx : 0;
}

}  // extern "C"
