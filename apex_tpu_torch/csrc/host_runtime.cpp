// apex_tpu_torch host runtime: the host-side machinery of the checkpoint.
//
// Device code is CUDA (the other sources of this directory); the host-side
// hot paths, gathering many parameter buffers into one contiguous pack and
// streaming checkpoints between host memory and disk, are plain-C-ABI C++
// that runs with the GIL released, loaded from Python with ctypes
// (apex_tpu_torch/utils/native.py builds it with g++ at first use).  It is
// the same library as the JAX package's csrc/host_runtime.cpp: the two
// write and read one checkpoint format.
//
// Exported C ABI (all return 0 on success, negative errno-style on error):
//   apex_pack(srcs, sizes, n, dst)            gather n buffers -> dst
//   apex_unpack(src, dsts, sizes, n)          scatter src -> n buffers
//   apex_file_write(path, buf, size, threads) parallel chunked pwrite
//   apex_file_read(path, buf, size, threads)  parallel chunked pread
//   apex_file_read_at(path, buf, size, offset, threads)
//                                             the same from a file offset
//   apex_version()                            ABI version int

#include <cerrno>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

// Gather (GATHER) or scatter (!GATHER) between n separate buffers and one
// contiguous pack.  Inputs split across threads at buffer granularity.
template <bool GATHER>
int copy_many(void *pack, void *const *bufs, const size_t *sizes, int n) {
  if (n < 0) return -EINVAL;
  size_t total = 0;
  std::vector<size_t> offs((size_t)n);
  for (int i = 0; i < n; ++i) {
    offs[(size_t)i] = total;
    total += sizes[i];
  }
  unsigned hw = std::thread::hardware_concurrency();
  int nt = (int)(hw ? hw : 1);
  if (nt > n) nt = n > 0 ? n : 1;
  if (total < (1u << 20)) nt = 1;  // small packs: thread spawn dominates
  auto run = [&](int t) {
    for (int i = t; i < n; i += nt) {
      char *at = (char *)pack + offs[(size_t)i];
      if (GATHER)
        std::memcpy(at, bufs[i], sizes[i]);
      else
        std::memcpy(bufs[i], at, sizes[i]);
    }
  };
  if (nt == 1) {
    run(0);
  } else {
    std::vector<std::thread> ts;
    ts.reserve((size_t)nt);
    for (int t = 0; t < nt; ++t) ts.emplace_back(run, t);
    for (auto &th : ts) th.join();
  }
  return 0;
}

// Parallel chunked file IO: each thread opens its own fd and
// preads/pwrites a contiguous slice, so the kernel can keep multiple
// requests in flight (the host-side analogue of cuFile's multi-channel
// DMA; the buffer is host memory that the caller copies to the card).
template <bool WRITE>
int file_io(const char *path, void *buf, size_t size, int threads,
            off_t base = 0) {
  if (threads < 1) threads = 1;
  if (size < (8u << 20)) threads = 1;  // <8 MiB: syscall path is enough
  int flags = WRITE ? (O_WRONLY | O_CREAT) : O_RDONLY;
  if (WRITE) {
    // create + size the file once so per-thread fds can pwrite anywhere
    int fd = open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
    if (fd < 0) return -errno;
    if (size > 0 && ftruncate(fd, (off_t)size) != 0) {
      int e = errno;
      close(fd);
      return -e;
    }
    close(fd);
  }
  std::vector<int> errs((size_t)threads, 0);
  size_t chunk = (size + (size_t)threads - 1) / (size_t)threads;
  auto run = [&](int t) {
    size_t off = (size_t)t * chunk;
    if (off >= size) return;
    size_t end = off + chunk < size ? off + chunk : size;
    int fd = open(path, flags, 0644);
    if (fd < 0) {
      errs[(size_t)t] = -errno;
      return;
    }
    char *p = (char *)buf + off;
    size_t left = end - off;
    while (left > 0) {
      ssize_t k = WRITE ? pwrite(fd, p, left, base + (off_t)off)
                        : pread(fd, p, left, base + (off_t)off);
      if (k <= 0) {
        errs[(size_t)t] = k == 0 ? -EIO : -errno;
        break;
      }
      p += k;
      off += (size_t)k;
      left -= (size_t)k;
    }
    close(fd);
  };
  if (threads == 1) {
    run(0);
  } else {
    std::vector<std::thread> ts;
    ts.reserve((size_t)threads);
    for (int t = 0; t < threads; ++t) ts.emplace_back(run, t);
    for (auto &th : ts) th.join();
  }
  for (int e : errs)
    if (e != 0) return e;
  return 0;
}

}  // namespace

extern "C" {

int apex_version() { return 1; }

int apex_pack(const void **srcs, const size_t *sizes, int n, void *dst) {
  return copy_many<true>(dst, const_cast<void *const *>(srcs), sizes, n);
}

int apex_unpack(const void *src, void **dsts, const size_t *sizes, int n) {
  return copy_many<false>(const_cast<void *>(src), dsts, sizes, n);
}

int apex_file_write(const char *path, const void *buf, size_t size,
                    int threads) {
  return file_io<true>(path, const_cast<void *>(buf), size, threads);
}

int apex_file_read(const char *path, void *buf, size_t size, int threads) {
  return file_io<false>(path, buf, size, threads);
}

int apex_file_read_at(const char *path, void *buf, size_t size,
                      long long offset, int threads) {
  if (offset < 0) return -EINVAL;
  return file_io<false>(path, buf, size, threads, (off_t)offset);
}

}  // extern "C"
