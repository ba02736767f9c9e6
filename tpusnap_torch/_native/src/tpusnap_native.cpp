// Native helpers for tpusnap_torch's hot host I/O paths.
//
// A verbatim copy of tpusnap/_native/src/tpusnap_native.cpp: the port keeps
// the same GIL-released file writes, ranged reads, CRC32C and XXH64, so a
// snapshot written by either package carries byte-identical checksums.
//
//   ts_write_file    — whole-buffer file write (single open/write loop, no
//                      Python-level chunking, GIL released by the caller)
//   ts_write_file_auto — engine-picking whole-file write: O_DIRECT
//                      zero-copy for aligned sources, RWF_DONTCACHE
//                      uncached buffered I/O for unaligned ones, bounce
//                      pipeline fallback (ts_write_file_direct2); plain
//                      buffered writes hit the dirty-page writeback
//                      throttle well below device speed on large streams
//   ts_read_range    — positional ranged read into a caller buffer
//                      (ts_read_range_direct2: O_DIRECT, preads straight
//                      into aligned destinations)
//   ts_memcpy_par    — multi-threaded memcpy for staging large host buffers
//   ts_crc32c        — CRC32C (Castagnoli, software slice-by-8) for
//                      optional integrity checksums
//
// Built on demand by tpusnap_torch/_native/__init__.py with:
//   g++ -O3 -shared -fPIC -pthread -o libtpusnap_native.so tpusnap_native.cpp

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <thread>
#include <unistd.h>
#include <vector>

#ifdef __linux__
#include <sys/statfs.h>
#include <sys/uio.h>
#endif

// Uncached buffered I/O (Linux 6.14+): write through the page cache —
// so no alignment requirements and a single CPU copy — but kick off
// writeback immediately and drop the pages once it completes. Unlike a
// plain buffered stream, dirty pages never pile up into the writeback
// throttle, and unlike O_DIRECT no bounce buffer is needed for
// unaligned sources. Kernels/filesystems without support fail with
// EOPNOTSUPP/EINVAL and the caller falls back.
#ifndef RWF_DONTCACHE
#define RWF_DONTCACHE 0x00000080
#endif

#ifndef O_DIRECT
#define O_DIRECT 0
#endif

#ifndef TMPFS_MAGIC
#define TMPFS_MAGIC 0x01021994
#endif
#ifndef RAMFS_MAGIC
#define RAMFS_MAGIC 0x858458f6
#endif

// RAM-backed filesystems accept O_DIRECT on recent kernels, but there the
// "device" is a kernel memcpy: the direct path's bounce buffer would just
// add a second CPU copy. A single buffered write is the fastest option.
static bool is_ram_backed(int fd) {
#ifdef __linux__
  struct statfs sfs;
  if (::fstatfs(fd, &sfs) != 0) return false;
  return sfs.f_type == TMPFS_MAGIC || sfs.f_type == RAMFS_MAGIC;
#else
  (void)fd;
  return false;
#endif
}

extern "C" {

int ts_write_file(const char* path, const void* buf, size_t n);
int64_t ts_read_range(const char* path, void* out, int64_t offset, size_t n);
int64_t ts_read_range_direct(const char* path, void* out, int64_t offset,
                             size_t n);
uint32_t ts_crc32c(const void* buf, size_t n, uint32_t seed);

// Returns 0 on success, -errno on failure.
int ts_write_file(const char* path, const void* buf, size_t n) {
  int fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -errno;
  const char* p = static_cast<const char*>(buf);
  size_t remaining = n;
  while (remaining > 0) {
    ssize_t written = ::write(fd, p, remaining);
    if (written < 0) {
      if (errno == EINTR) continue;
      int err = errno;
      ::close(fd);
      return -err;
    }
    p += written;
    remaining -= static_cast<size_t>(written);
  }
  if (::close(fd) < 0) return -errno;
  return 0;
}

// O_DIRECT whole-file write with a configurable number of in-flight
// chunk writes (device queue depth) and chunk size. Returns 0 on success
// or -errno. Falls back to the buffered path when O_DIRECT open fails
// (overlayfs, unsupported filesystems), when the target is RAM-backed
// (tmpfs — a bounce copy there only doubles the CPU cost), or for small
// buffers where the setup cost outweighs the page-cache bypass.
//
// Two modes:
// - source 4096-aligned: ZERO-COPY — nthreads workers pwrite directly
//   from the caller's buffer, round-robin over chunks. No bounce memcpy
//   at all (buffers tpusnap allocates itself — slabs, async clones,
//   staged copies — are aligned for exactly this reason).
// - unaligned source (arbitrary user numpy arrays): bounce pipeline with
//   nthreads in-flight chunk writes and nthreads+1 bounce buffers; the
//   caller thread's memcpy into the next free bounce buffer overlaps the
//   in-flight pwrites.
int ts_write_file_direct2(const char* path, const void* buf, size_t n,
                          int nthreads, size_t chunk) {
  static const size_t kAlign = 4096;
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 16) nthreads = 16;
  if (chunk < (1u << 20)) chunk = 1u << 20;
  chunk &= ~(kAlign - 1);
  if (O_DIRECT == 0 || n < (4u << 20)) return ts_write_file(path, buf, n);
  int fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC | O_DIRECT, 0644);
  if (fd < 0) return ts_write_file(path, buf, n);
  if (is_ram_backed(fd)) {
    ::close(fd);
    return ts_write_file(path, buf, n);
  }
#ifdef __linux__
  // Reserve the full extent up front: without this, concurrent direct
  // writers allocate blocks chunk-by-chunk and interleave their extents,
  // which turns later sequential restore reads into seek storms.
  // posix_fallocate returns the error number directly (not via errno).
  // ENOSPC must fail now: letting the write proceed surfaces the failure
  // later and then masks it behind a full buffered rewrite of a possibly
  // multi-GB file. Other errors (EOPNOTSUPP on odd filesystems) are
  // non-fatal — the writes below allocate blocks themselves.
  int fa = ::posix_fallocate(fd, 0, static_cast<off_t>(n));
  if (fa == ENOSPC) {
    ::close(fd);
    ::unlink(path);
    return -ENOSPC;
  }
#endif

  const size_t aligned_n = n & ~(kAlign - 1);
  const char* src = static_cast<const char*>(buf);
  std::atomic<int> werr{0};

  if (reinterpret_cast<uintptr_t>(buf) % kAlign == 0) {
    // Zero-copy: workers write straight from the source buffer.
    std::atomic<size_t> next{0};
    std::vector<std::thread> workers;
    workers.reserve(nthreads);
    for (int t = 0; t < nthreads; ++t) {
      workers.emplace_back([&] {
        for (;;) {
          const size_t off = next.fetch_add(chunk);
          if (off >= aligned_n || werr.load()) return;
          const size_t len =
              (aligned_n - off < chunk) ? (aligned_n - off) : chunk;
          size_t pos = 0;
          while (pos < len) {
            ssize_t w = ::pwrite(fd, src + off + pos, len - pos, off + pos);
            if (w < 0) {
              if (errno == EINTR) continue;
              werr.store(errno);
              return;
            }
            pos += static_cast<size_t>(w);
          }
        }
      });
    }
    for (auto& t : workers) t.join();
  } else {
    // Bounce pipeline: nthreads in-flight chunk writes, nthreads+1
    // bounce buffers so the caller's memcpy overlaps all of them. The
    // bounce chunk is capped at 8 MiB regardless of the zero-copy chunk
    // knob: this memory is invisible to the scheduler's staging budget,
    // and at the scheduler's 16-file I/O concurrency larger chunks would
    // pin (16 x (qd+1) x chunk) of untracked RSS.
    if (chunk > (8u << 20)) chunk = 8u << 20;
    const int nbufs = nthreads + 1;
    std::vector<void*> bounce(nbufs, nullptr);
    bool alloc_ok = true;
    for (int i = 0; i < nbufs; ++i) {
      if (::posix_memalign(&bounce[i], kAlign, chunk) != 0) {
        alloc_ok = false;
        break;
      }
    }
    if (!alloc_ok) {
      for (void* b : bounce) std::free(b);
      ::close(fd);
      return ts_write_file(path, buf, n);
    }
    // (thread, buffer index) pairs in flight, oldest first.
    std::deque<std::pair<std::thread, int>> inflight;
    std::deque<int> free_bufs;
    for (int i = 0; i < nbufs; ++i) free_bufs.push_back(i);
    size_t off = 0;
    while (off < aligned_n && !werr.load()) {
      if (free_bufs.empty()) {
        inflight.front().first.join();
        free_bufs.push_back(inflight.front().second);
        inflight.pop_front();
        continue;
      }
      const int bi = free_bufs.front();
      free_bufs.pop_front();
      const size_t len =
          (aligned_n - off < chunk) ? (aligned_n - off) : chunk;
      char* wbuf = static_cast<char*>(bounce[bi]);
      std::memcpy(wbuf, src + off, len);  // overlaps in-flight pwrites
      const size_t woff = off;
      inflight.emplace_back(
          std::thread([fd, wbuf, len, woff, &werr] {
            size_t pos = 0;
            while (pos < len) {
              ssize_t w = ::pwrite(fd, wbuf + pos, len - pos, woff + pos);
              if (w < 0) {
                if (errno == EINTR) continue;
                werr.store(errno);
                return;
              }
              pos += static_cast<size_t>(w);
            }
          }),
          bi);
      off += len;
    }
    while (!inflight.empty()) {
      inflight.front().first.join();
      inflight.pop_front();
    }
    for (void* b : bounce) std::free(b);
  }
  ::close(fd);
  if (werr.load() == ENOSPC) {
    // A full disk won't be cured by a buffered rewrite of the same bytes
    // — fail now instead of doubling the multi-GB I/O on the error path
    // (reachable when posix_fallocate was unsupported, e.g. FUSE).
    ::unlink(path);
    return -ENOSPC;
  }
  if (werr.load()) {
    // Write-phase failure. This covers filesystems/devices that accept
    // O_DIRECT at open() but reject the I/O (logical block size > kAlign,
    // FUSE quirks) and short writes that left the continuation offset
    // unaligned (EINVAL masking the true cause, e.g. a filling disk). A
    // buffered rewrite either succeeds or reports the real errno; when it
    // fails too (disk genuinely full), don't leave a partial blob behind.
    int rc = ts_write_file(path, buf, n);
    if (rc != 0) ::unlink(path);
    return rc;
  }

  // Unaligned tail: a buffered positional write (offset need not be
  // block-aligned once the O_DIRECT fd is closed).
  if (aligned_n < n) {
    // Don't leave a partial blob behind on failure, matching the
    // ENOSPC and buffered-rewrite error paths above.
    int tfd = ::open(path, O_WRONLY);
    if (tfd < 0) {
      int err = errno;
      ::unlink(path);
      return -err;
    }
    const char* p = src + aligned_n;
    size_t remaining = n - aligned_n;
    off_t pos = static_cast<off_t>(aligned_n);
    while (remaining > 0) {
      ssize_t w = ::pwrite(tfd, p, remaining, pos);
      if (w < 0) {
        if (errno == EINTR) continue;
        int err = errno;
        ::close(tfd);
        ::unlink(path);
        return -err;
      }
      p += w;
      pos += w;
      remaining -= static_cast<size_t>(w);
    }
    if (::close(tfd) < 0) {
      int err = errno;
      ::unlink(path);
      return -err;
    }
  }
  return 0;
}

// Whole-file write via uncached buffered I/O (RWF_DONTCACHE). Returns 0
// or -errno; -EOPNOTSUPP/-EINVAL mean the kernel/filesystem lacks
// support and the caller should fall back to the O_DIRECT path.
int ts_write_file_dontcache(const char* path, const void* buf, size_t n) {
#ifndef __linux__
  (void)path;
  (void)buf;
  (void)n;
  return -EOPNOTSUPP;
#else
  static const size_t kChunk = 8u << 20;
  int fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -errno;
  const char* p = static_cast<const char*>(buf);
  size_t off = 0;
  while (off < n) {
    const size_t len = (n - off < kChunk) ? (n - off) : kChunk;
    struct iovec iov = {const_cast<char*>(p + off), len};
    ssize_t w = ::pwritev2(fd, &iov, 1, static_cast<off_t>(off),
                           RWF_DONTCACHE);
    if (w < 0) {
      if (errno == EINTR) continue;
      int err = errno;
      ::close(fd);
      return -err;
    }
    if (w == 0) {
      ::close(fd);
      return -EIO;
    }
    off += static_cast<size_t>(w);
  }
  if (::close(fd) < 0) return -errno;
  return 0;
#endif
}

// Preferred whole-file write: picks the cheapest correct engine.
// - aligned source on an O_DIRECT-capable fs: O_DIRECT zero-copy (no CPU
//   copy at all, data at the device on return);
// - unaligned source + allow_dontcache: uncached buffered write (one
//   CPU copy, no bounce buffer, writeback already in flight on return);
// - aligned source where O_DIRECT open fails (overlayfs etc.):
//   dontcache — falling straight to the plain buffered path would hit
//   the dirty-page writeback throttle this module exists to avoid;
// - otherwise: O_DIRECT bounce pipeline / buffered fallback.
int ts_write_file_auto(const char* path, const void* buf, size_t n,
                       int nthreads, size_t chunk, int allow_dontcache) {
  if (O_DIRECT == 0 || n < (4u << 20)) return ts_write_file(path, buf, n);
  const bool aligned = reinterpret_cast<uintptr_t>(buf) % 4096 == 0;
  bool try_dontcache = allow_dontcache && !aligned;
  if (aligned && allow_dontcache) {
    int probe = ::open(path, O_WRONLY | O_CREAT | O_DIRECT, 0644);
    if (probe < 0) {
      try_dontcache = true;  // no O_DIRECT on this fs
    } else {
      ::close(probe);
    }
  }
  if (try_dontcache) {
    int rc = ts_write_file_dontcache(path, buf, n);
    if (rc == 0) return 0;
    if (rc != -EOPNOTSUPP && rc != -EINVAL) {
      // Real I/O failure: don't leave a partial multi-GB blob behind
      // (matches the direct engines' cleanup contract).
      ::unlink(path);
      return rc;
    }
    // Unsupported here — fall through to the O_DIRECT engines.
  }
  return ts_write_file_direct2(path, buf, n, nthreads, chunk);
}

// Positional ranged read. Returns bytes read (>=0) or -errno.
int64_t ts_read_range(const char* path, void* out, int64_t offset, size_t n) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -errno;
#ifdef POSIX_FADV_SEQUENTIAL
  // Large sequential consumers: widen kernel readahead (the default
  // window caps buffered cold reads well below device speed).
  ::posix_fadvise(fd, offset, n, POSIX_FADV_SEQUENTIAL);
  ::posix_fadvise(fd, offset, n, POSIX_FADV_WILLNEED);
#endif
  char* p = static_cast<char*>(out);
  size_t remaining = n;
  int64_t pos = offset;
  while (remaining > 0) {
    ssize_t got = ::pread(fd, p, remaining, pos);
    if (got < 0) {
      if (errno == EINTR) continue;
      int err = errno;
      ::close(fd);
      return -err;
    }
    if (got == 0) break;  // EOF
    p += got;
    pos += got;
    remaining -= static_cast<size_t>(got);
  }
  ::close(fd);
  return static_cast<int64_t>(n - remaining);
}

// Zero-copy O_DIRECT ranged read: when the destination buffer and file
// offset are 4096-aligned (buffers tpusnap allocates are), workers pread
// straight into the caller's buffer — no bounce memcpy at all. This
// matters most on few-core hosts: a bounce copy per concurrent reader
// starves the deserialize/copy consumers running on the same cores.
// Returns bytes read or -errno; falls back to the bounce-buffer variant
// (ts_read_range_direct) when alignment doesn't hold, and to buffered
// reads on RAM-backed filesystems (the page "cache" IS the storage
// there; O_DIRECT would only forfeit the kernel's fast path).
int64_t ts_read_range_direct2(const char* path, void* out, int64_t offset,
                              size_t n, int nthreads, size_t chunk) {
  static const int64_t kAlign = 4096;
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 16) nthreads = 16;
  if (chunk < (1u << 20)) chunk = 1u << 20;
  chunk &= ~(static_cast<size_t>(kAlign) - 1);
  if (O_DIRECT == 0 || n < (4u << 20))
    return ts_read_range(path, out, offset, n);
  if (reinterpret_cast<uintptr_t>(out) % kAlign != 0 || offset % kAlign != 0)
    return ts_read_range_direct(path, out, offset, n);
  int fd = ::open(path, O_RDONLY | O_DIRECT, 0);
  if (fd < 0) return ts_read_range(path, out, offset, n);
  if (is_ram_backed(fd)) {
    ::close(fd);
    return ts_read_range(path, out, offset, n);
  }
  struct stat st;
  if (::fstat(fd, &st) != 0) {
    ::close(fd);
    return ts_read_range(path, out, offset, n);
  }
  const int64_t file_size = st.st_size;
  const int64_t req_end =
      (offset + static_cast<int64_t>(n) < file_size)
          ? offset + static_cast<int64_t>(n)
          : file_size;
  if (req_end <= offset) {
    ::close(fd);
    return 0;
  }
  // Whole blocks inside the file land direct; the final partial block
  // (when the request reaches into it) goes through a buffered pread.
  const int64_t a_end = req_end & ~(kAlign - 1);
  char* dst = static_cast<char*>(out);
  std::atomic<int> rerr{0};
  std::atomic<bool> rshort{false};
  if (a_end > offset) {
    std::atomic<int64_t> next{offset};
    std::vector<std::thread> workers;
    workers.reserve(nthreads);
    for (int t = 0; t < nthreads; ++t) {
      workers.emplace_back([&, fd] {
        for (;;) {
          const int64_t off = next.fetch_add(static_cast<int64_t>(chunk));
          if (off >= a_end || rerr.load() || rshort.load()) return;
          const int64_t len =
              (a_end - off < static_cast<int64_t>(chunk))
                  ? (a_end - off)
                  : static_cast<int64_t>(chunk);
          int64_t pos = 0;
          while (pos < len) {
            ssize_t got =
                ::pread(fd, dst + (off - offset) + pos, len - pos, off + pos);
            if (got < 0) {
              if (errno == EINTR) continue;
              rerr.store(errno);
              return;
            }
            if (got == 0) {  // file shrank under us
              rshort.store(true);
              return;
            }
            pos += got;
          }
        }
      });
    }
    for (auto& t : workers) t.join();
  }
  ::close(fd);
  if (rerr.load() || rshort.load())
    return ts_read_range(path, out, offset, n);
  int64_t total = a_end - offset;
  if (req_end > a_end) {
    int64_t tail = ts_read_range(path, dst + (a_end - offset), a_end,
                                 static_cast<size_t>(req_end - a_end));
    if (tail < 0) return tail;
    total += tail;
  }
  return total;
}

// O_DIRECT double-buffered ranged read: bypasses the page cache, whose
// bounded readahead window caps cold buffered reads far below device
// speed. The requested range is covered by aligned block reads through a
// bounce buffer (memcpy out overlaps the next in-flight pread); any
// misaligned head/tail falls back to a buffered pread. Returns bytes
// read or -errno; falls back to ts_read_range when O_DIRECT open fails.
int64_t ts_read_range_direct(const char* path, void* out, int64_t offset,
                             size_t n) {
  static const int64_t kAlign = 4096;
  static const size_t kChunk = 8u << 20;
  if (O_DIRECT == 0 || n < (4u << 20))
    return ts_read_range(path, out, offset, n);
  int fd = ::open(path, O_RDONLY | O_DIRECT, 0);
  if (fd < 0) return ts_read_range(path, out, offset, n);

  struct stat st;
  if (::fstat(fd, &st) != 0) {
    ::close(fd);
    return ts_read_range(path, out, offset, n);
  }
  const int64_t file_size = st.st_size;
  const int64_t req_end =
      (offset + static_cast<int64_t>(n) < file_size)
          ? offset + static_cast<int64_t>(n)
          : file_size;
  if (req_end <= offset) {
    ::close(fd);
    return 0;
  }
  // Aligned window fully covered by whole blocks inside the file. When
  // the request starts inside the file's final partial block the window
  // is empty (a_end < a_start) — nothing direct-readable, use buffered.
  const int64_t a_start = (offset + kAlign - 1) & ~(kAlign - 1);
  const int64_t a_end = req_end & ~(kAlign - 1);
  if (a_end <= a_start) {
    ::close(fd);
    return ts_read_range(path, out, offset, n);
  }

  void* bounce[2] = {nullptr, nullptr};
  if (::posix_memalign(&bounce[0], kAlign, kChunk) != 0 ||
      ::posix_memalign(&bounce[1], kAlign, kChunk) != 0) {
    std::free(bounce[0]);
    std::free(bounce[1]);
    ::close(fd);
    return ts_read_range(path, out, offset, n);
  }

  char* dst = static_cast<char*>(out);
  // Per-buffer results: chunk i writes slot i&1, so the two in-flight
  // chunks never share a result slot. <0: -errno; >=0: bytes read.
  std::atomic<int64_t> rres[2] = {{0}, {0}};
  std::thread reader;
  int err = 0;
  int64_t pos = a_start;
  int idx = 0;
  int64_t pending_len = 0;  // length of the chunk the reader is filling
  int pending_idx = 0;
  int64_t pending_pos = 0;
  bool short_read = false;
  while (pos < a_end && !short_read) {
    const int64_t len =
        (a_end - pos < static_cast<int64_t>(kChunk)) ? (a_end - pos)
                                                     : static_cast<int64_t>(kChunk);
    char* buf = static_cast<char*>(bounce[idx]);
    std::atomic<int64_t>* slot = &rres[idx];
    // Kick off the pread for this chunk, then (on the main thread) copy
    // the PREVIOUS chunk out while it is in flight.
    std::thread t([fd, buf, len, pos, slot] {
      int64_t done = 0;
      while (done < len) {
        ssize_t got = ::pread(fd, buf + done, len - done, pos + done);
        if (got < 0) {
          if (errno == EINTR) continue;
          slot->store(-static_cast<int64_t>(errno));
          return;
        }
        if (got == 0) break;  // EOF (file shrank under us)
        done += got;
      }
      slot->store(done);
    });
    if (reader.joinable()) {
      reader.join();
      const int64_t got = rres[pending_idx].load();
      if (got < 0) {
        err = static_cast<int>(-got);
        t.join();
        reader = std::thread();
        break;
      }
      std::memcpy(dst + (pending_pos - offset), bounce[pending_idx],
                  static_cast<size_t>(got));
      if (got < pending_len) short_read = true;
    }
    reader = std::move(t);
    pending_len = len;
    pending_idx = idx;
    pending_pos = pos;
    pos += len;
    idx ^= 1;
  }
  if (reader.joinable()) {
    reader.join();
    const int64_t got = rres[pending_idx].load();
    if (got < 0) {
      if (err == 0) err = static_cast<int>(-got);
    } else if (err == 0 && !short_read) {
      std::memcpy(dst + (pending_pos - offset), bounce[pending_idx],
                  static_cast<size_t>(got));
      if (got < pending_len) short_read = true;
    }
  }
  std::free(bounce[0]);
  std::free(bounce[1]);
  ::close(fd);
  if (err != 0) return ts_read_range(path, out, offset, n);

  // Misaligned head ([offset, a_start)) and tail ([a_end, req_end)) via
  // buffered preads; also re-read everything after an unexpected short
  // direct read through the buffered path.
  if (short_read) return ts_read_range(path, out, offset, n);
  int64_t total = a_end - a_start;
  if (a_start > offset) {
    int64_t head = ts_read_range(path, dst, offset, a_start - offset);
    if (head < 0) return head;
    total += head;
  }
  if (req_end > a_end) {
    int64_t tail = ts_read_range(path, dst + (a_end - offset), a_end,
                                 static_cast<size_t>(req_end - a_end));
    if (tail < 0) return tail;
    total += tail;
  }
  return total;
}

// Fused read-into-destination with optional inline CRC32C.
//
// Restores on few-core hosts are CPU-ceiling-bound, not disk-bound: the
// scratch-buffer pipeline costs one DMA + a checksum pass + a memcpy pass
// per byte, all competing for the same cores as the storage interrupts.
// This op reads [offset, offset+n) of `path` straight into the caller's
// (arbitrarily aligned) destination and computes the checksum DURING the
// bounce copy-out — sub-blocks sized to stay in L1, so the CRC pass reads
// cache-hot bytes and RAM traffic is one read + one write per byte total.
// The scheduler's consume stage then verifies a 4-byte value instead of
// re-reading gigabytes.
//
// Engine choice mirrors ts_read_range_direct: O_DIRECT chunked preads
// through bounce buffers (nthreads in flight, processed strictly in file
// order because CRC32C is sequential), buffered fallback for small
// ranges / unsupported filesystems / RAM-backed mounts, misaligned head
// and tail via buffered preads. If the destination and file offset are
// both block-aligned, the zero-copy direct reader is used instead and the
// checksum (when requested) is one pass over the destination.
//
// Returns bytes read (short only at EOF) or -errno. *crc_out is written
// only on success, and only when crc_out != NULL.

static uint32_t ts_crccpy(char* dst, const char* src, size_t n, uint32_t crc,
                          int want_crc) {
  if (!want_crc) {
    std::memcpy(dst, src, n);
    return crc;
  }
  static const size_t kSub = 65536;  // L1/L2-resident sub-block
  size_t off = 0;
  while (off < n) {
    const size_t len = (n - off < kSub) ? (n - off) : kSub;
    // CRC the source sub-block first (brings it into cache), then copy
    // the cache-hot bytes out: one RAM read + one RAM write per byte,
    // and no store-to-load traffic on the just-written destination.
    crc = ts_crc32c(src + off, len, crc);
    std::memcpy(dst + off, src + off, len);
    off += len;
  }
  return crc;
}

static int64_t read_into_buffered_crc(const char* path, void* out,
                                      int64_t offset, size_t n,
                                      uint32_t* crc_out) {
  int64_t got = ts_read_range(path, out, offset, n);
  if (got < 0) return got;
  if (crc_out != nullptr)
    *crc_out = ts_crc32c(out, static_cast<size_t>(got), 0);
  return got;
}

int64_t ts_read_range_into_crc(const char* path, void* out, int64_t offset,
                               size_t n, int nthreads, size_t chunk,
                               uint32_t* crc_out) {
  static const int64_t kAlign = 4096;
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 8) nthreads = 8;
  // Bounce memory here is invisible to the scheduler's budget; cap it.
  if (chunk < (1u << 20)) chunk = 1u << 20;
  if (chunk > (8u << 20)) chunk = 8u << 20;
  chunk &= ~(static_cast<size_t>(kAlign) - 1);
  if (O_DIRECT == 0 || n < (4u << 20))
    return read_into_buffered_crc(path, out, offset, n, crc_out);
  if (reinterpret_cast<uintptr_t>(out) % kAlign == 0 && offset % kAlign == 0) {
    int64_t got = ts_read_range_direct2(path, out, offset, n, nthreads,
                                        chunk * 4);
    if (got < 0) return got;
    if (crc_out != nullptr)
      *crc_out = ts_crc32c(out, static_cast<size_t>(got), 0);
    return got;
  }
  int fd = ::open(path, O_RDONLY | O_DIRECT, 0);
  if (fd < 0) return read_into_buffered_crc(path, out, offset, n, crc_out);
  if (is_ram_backed(fd)) {
    ::close(fd);
    return read_into_buffered_crc(path, out, offset, n, crc_out);
  }
  struct stat st;
  if (::fstat(fd, &st) != 0) {
    ::close(fd);
    return read_into_buffered_crc(path, out, offset, n, crc_out);
  }
  const int64_t file_size = st.st_size;
  const int64_t req_end =
      (offset + static_cast<int64_t>(n) < file_size)
          ? offset + static_cast<int64_t>(n)
          : file_size;
  if (req_end <= offset) {
    ::close(fd);
    if (crc_out != nullptr) *crc_out = ts_crc32c(out, 0, 0);
    return 0;
  }
  const int64_t a_start = (offset + kAlign - 1) & ~(kAlign - 1);
  const int64_t a_end = req_end & ~(kAlign - 1);
  if (a_end <= a_start) {
    ::close(fd);
    return read_into_buffered_crc(path, out, offset, n, crc_out);
  }

  // Don't allocate more bounce memory than the window needs: a small
  // (e.g. budget-tile) read must not pin (nthreads+1) full chunks.
  const int64_t window = a_end - a_start;
  if (static_cast<int64_t>(chunk) > window)
    chunk = static_cast<size_t>(window);  // window is block-aligned
  const int64_t n_chunks =
      (window + static_cast<int64_t>(chunk) - 1) / static_cast<int64_t>(chunk);
  const int nbufs =
      (n_chunks < nthreads + 1) ? static_cast<int>(n_chunks) : nthreads + 1;
  std::vector<void*> bounce(nbufs, nullptr);
  for (int i = 0; i < nbufs; ++i) {
    if (::posix_memalign(&bounce[i], kAlign, chunk) != 0) {
      for (void* b : bounce) std::free(b);
      ::close(fd);
      return read_into_buffered_crc(path, out, offset, n, crc_out);
    }
  }

  char* dst = static_cast<char*>(out);
  const int want_crc = crc_out != nullptr;
  uint32_t crc = 0;
  bool failed = false;
  bool short_read = false;

  // Misaligned head via buffered pread (CRC is sequential, so the head
  // must be hashed before the first aligned chunk).
  if (a_start > offset) {
    int64_t head = ts_read_range(path, dst, offset,
                                 static_cast<size_t>(a_start - offset));
    if (head < 0 || head < a_start - offset) failed = true;
    if (!failed && want_crc)
      crc = ts_crc32c(dst, static_cast<size_t>(a_start - offset), crc);
  }

  if (!failed) {
    // nthreads chunk preads in flight; the main thread drains them in
    // strict file order, fusing the bounce->dst copy with the CRC.
    struct Inflight {
      std::thread thread;
      int buf_idx;
      int64_t pos;
      int64_t len;
    };
    std::vector<std::atomic<int64_t>> results(nbufs);
    std::deque<Inflight> inflight;
    std::deque<int> free_bufs;
    for (int i = 0; i < nbufs; ++i) free_bufs.push_back(i);
    int64_t pos = a_start;
    while ((pos < a_end || !inflight.empty()) && !failed && !short_read) {
      while (pos < a_end && !free_bufs.empty() &&
             static_cast<int>(inflight.size()) < nthreads) {
        const int bi = free_bufs.front();
        free_bufs.pop_front();
        const int64_t len = (a_end - pos < static_cast<int64_t>(chunk))
                                ? (a_end - pos)
                                : static_cast<int64_t>(chunk);
        char* buf = static_cast<char*>(bounce[bi]);
        std::atomic<int64_t>* slot = &results[bi];
        inflight.push_back(Inflight{
            std::thread([fd, buf, len, pos, slot] {
              int64_t done = 0;
              while (done < len) {
                ssize_t got =
                    ::pread(fd, buf + done, len - done, pos + done);
                if (got < 0) {
                  if (errno == EINTR) continue;
                  slot->store(-static_cast<int64_t>(errno));
                  return;
                }
                if (got == 0) break;  // file shrank under us
                done += got;
              }
              slot->store(done);
            }),
            bi, pos, len});
        pos += len;
      }
      Inflight f = std::move(inflight.front());
      inflight.pop_front();
      f.thread.join();
      const int64_t got = results[f.buf_idx].load();
      if (got < 0) {
        failed = true;
      } else {
        crc = ts_crccpy(dst + (f.pos - offset),
                        static_cast<char*>(bounce[f.buf_idx]),
                        static_cast<size_t>(got), crc, want_crc);
        if (got < f.len) short_read = true;
      }
      free_bufs.push_back(f.buf_idx);
    }
    for (auto& rem : inflight) rem.thread.join();
  }

  for (void* b : bounce) std::free(b);
  ::close(fd);
  // A short direct read means the file changed size mid-read; re-read the
  // whole range through the simple buffered path for a consistent result.
  if (failed || short_read)
    return read_into_buffered_crc(path, out, offset, n, crc_out);

  // Tail ([a_end, req_end)) via buffered pread.
  int64_t total = a_end - offset;
  if (req_end > a_end) {
    int64_t tail = ts_read_range(path, dst + (a_end - offset), a_end,
                                 static_cast<size_t>(req_end - a_end));
    if (tail < 0) return tail;
    if (want_crc)
      crc = ts_crc32c(dst + (a_end - offset), static_cast<size_t>(tail), crc);
    total += tail;
  }
  if (crc_out != nullptr) *crc_out = crc;
  return total;
}

// Fused clone + per-tile CRC32C: copies [src, src+n) to dst while
// computing an independent (seed-0) CRC per ``tile`` bytes into
// crcs[0..ceil(n/tile)). One memory pass instead of a hash pass plus a
// copy pass — this is the async-snapshot staging hot path, where the
// defensive clone and the integrity checksum would otherwise each read
// every byte. Tiles are independent, so they parallelize across
// nthreads; the caller derives the whole-blob CRC with
// ts_crc32c_combine. n == 0 writes nothing (caller handles empties).
void ts_memcpy_crc_tiles(void* dst, const void* src, size_t n, size_t tile,
                         uint32_t* crcs, int nthreads) {
  if (n == 0) return;
  if (tile == 0 || tile > n) tile = n;
  const size_t n_tiles = (n + tile - 1) / tile;
  std::atomic<size_t> next{0};
  auto work = [&] {
    for (;;) {
      const size_t i = next.fetch_add(1);
      if (i >= n_tiles) return;
      const size_t off = i * tile;
      const size_t len = (n - off < tile) ? (n - off) : tile;
      crcs[i] = ts_crccpy(static_cast<char*>(dst) + off,
                          static_cast<const char*>(src) + off, len, 0, 1);
    }
  };
  if (nthreads <= 1 || n_tiles == 1 || n < (8u << 20)) {
    work();
    return;
  }
  const int nt = (static_cast<size_t>(nthreads) < n_tiles)
                     ? nthreads
                     : static_cast<int>(n_tiles);
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(work);
  for (auto& t : threads) t.join();
}

// Multi-threaded memcpy; nthreads <= 1 degrades to plain memcpy.
void ts_memcpy_par(void* dst, const void* src, size_t n, int nthreads) {
  if (nthreads <= 1 || n < (8u << 20)) {
    std::memcpy(dst, src, n);
    return;
  }
  size_t chunk = (n + nthreads - 1) / nthreads;
  std::vector<std::thread> threads;
  threads.reserve(nthreads);
  for (int i = 0; i < nthreads; ++i) {
    size_t off = static_cast<size_t>(i) * chunk;
    if (off >= n) break;
    size_t len = (off + chunk <= n) ? chunk : (n - off);
    threads.emplace_back([=] {
      std::memcpy(static_cast<char*>(dst) + off,
                  static_cast<const char*>(src) + off, len);
    });
  }
  for (auto& t : threads) t.join();
}

static uint32_t kCrcTable[8][256];
static bool kCrcInit = [] {
  const uint32_t poly = 0x82f63b78u;  // CRC32C (Castagnoli), reflected
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int j = 0; j < 8; ++j) crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    kCrcTable[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; ++i)
    for (int s = 1; s < 8; ++s)
      kCrcTable[s][i] =
          (kCrcTable[s - 1][i] >> 8) ^ kCrcTable[0][kCrcTable[s - 1][i] & 0xff];
  return true;
}();

uint32_t ts_crc32c_combine(uint32_t crc1, uint32_t crc2, uint64_t len2);

#ifdef __SSE4_2__
// One-lane hardware CRC over [p, p+n) given a RAW (non-inverted) state.
static uint64_t crc32c_hw_raw(const uint8_t* p, size_t n, uint64_t state) {
  while (n >= 8) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    state = __builtin_ia32_crc32di(state, v);
    p += 8;
    n -= 8;
  }
  uint32_t s32 = static_cast<uint32_t>(state);
  while (n--) s32 = __builtin_ia32_crc32qi(s32, *p++);
  return s32;
}
#endif

uint32_t ts_crc32c(const void* buf, size_t n, uint32_t seed) {
  (void)kCrcInit;
  uint32_t crc = ~seed;
  const uint8_t* p = static_cast<const uint8_t*>(buf);
#ifdef __SSE4_2__
  // Hardware CRC32C (the checksum exists to run at stage time inside the
  // take's hot path). A single crc32 dependency chain is latency-bound
  // (~8B / 3 cycles); for large buffers, THREE independent lanes run in
  // the instruction's throughput shadow and are merged with the GF(2)
  // combine — ~3x single-lane, bit-identical result.
  if (n >= (1u << 14)) {
    const size_t lane = (n / 3) & ~static_cast<size_t>(7);
    const uint8_t* p0 = p;
    const uint8_t* p1 = p + lane;
    const uint8_t* p2 = p + 2 * lane;
    uint64_t s0 = crc, s1 = 0xFFFFFFFFu, s2 = 0xFFFFFFFFu;
    size_t k = lane;
    while (k >= 8) {
      uint64_t v0, v1, v2;
      std::memcpy(&v0, p0, 8);
      std::memcpy(&v1, p1, 8);
      std::memcpy(&v2, p2, 8);
      s0 = __builtin_ia32_crc32di(s0, v0);
      s1 = __builtin_ia32_crc32di(s1, v1);
      s2 = __builtin_ia32_crc32di(s2, v2);
      p0 += 8;
      p1 += 8;
      p2 += 8;
      k -= 8;
    }
    // Lane results as finalized crcs (seeded 0 for lanes 1/2).
    uint32_t c0 = ~static_cast<uint32_t>(s0);
    uint32_t c1 = ~static_cast<uint32_t>(s1);
    uint32_t c2 = ~static_cast<uint32_t>(s2);
    uint32_t merged = ts_crc32c_combine(c0, c1, lane);
    merged = ts_crc32c_combine(merged, c2, lane);
    // Tail: remaining bytes after the three lanes, chained normally.
    const size_t tail_off = 3 * lane;
    return ts_crc32c(p + tail_off, n - tail_off, merged);
  }
  uint32_t out = static_cast<uint32_t>(crc32c_hw_raw(p, n, crc));
  return ~out;
#else
  while (n >= 8) {
    crc ^= static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
           (static_cast<uint32_t>(p[2]) << 16) |
           (static_cast<uint32_t>(p[3]) << 24);
    crc = kCrcTable[7][crc & 0xff] ^ kCrcTable[6][(crc >> 8) & 0xff] ^
          kCrcTable[5][(crc >> 16) & 0xff] ^ kCrcTable[4][crc >> 24] ^
          kCrcTable[3][p[4]] ^ kCrcTable[2][p[5]] ^ kCrcTable[1][p[6]] ^
          kCrcTable[0][p[7]];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ kCrcTable[0][(crc ^ *p++) & 0xff];
  return ~crc;
#endif
}

// CRC32C combine (zlib crc32_combine adapted to the Castagnoli
// polynomial): crc of a concatenation A||B from crc(A), crc(B), len(B),
// in O(log len2) GF(2) matrix operations. Lets the stager hash a blob
// ONCE at tile granularity and still record the whole-blob checksum, and
// lets tile-aligned partial reads be verified by combining recorded tile
// checksums — no second hash pass anywhere.
static uint32_t gf2_matrix_times(const uint32_t* mat, uint32_t vec) {
  uint32_t sum = 0;
  int i = 0;
  while (vec) {
    if (vec & 1) sum ^= mat[i];
    vec >>= 1;
    ++i;
  }
  return sum;
}

static void gf2_matrix_square(uint32_t* square, const uint32_t* mat) {
  for (int n = 0; n < 32; ++n) square[n] = gf2_matrix_times(mat, mat[n]);
}

// Shift operators for the combine: kShiftMat[k] advances a CRC past 2^k
// zero bytes. Computed once — the zlib-style algorithm re-derives them
// with 2 + 2*log2(len2) matrix squarings on EVERY call (~25 us), which
// put a ~50 us floor under each multi-lane hash and moved the 3-lane
// break-even from ~64 KiB to ~430 KiB.
static uint32_t kShiftMat[64][32];
static bool kShiftInit = [] {
  uint32_t odd[32];
  uint32_t even[32];
  odd[0] = 0x82f63b78u;  // CRC32C (Castagnoli), reflected: shift by 1 bit
  uint32_t row = 1;
  for (int n = 1; n < 32; ++n) {
    odd[n] = row;
    row <<= 1;
  }
  gf2_matrix_square(even, odd);          // 2 bits
  gf2_matrix_square(odd, even);          // 4 bits
  gf2_matrix_square(kShiftMat[0], odd);  // 8 bits = 1 byte
  for (int k = 1; k < 64; ++k)
    gf2_matrix_square(kShiftMat[k], kShiftMat[k - 1]);
  return true;
}();

// ---------------------------------------------------------------------------
// XXH64 — the second, independent hash backing incremental-dedup equality.
//
// A single 32-bit CRC per blob makes "unchanged" decisions with a ~2^-32
// silent-collision channel per blob-take (a changed blob whose CRC
// collides with the base's skips its write and restores stale data, and
// the scrub passes because the manifest records the colliding value).
// Dedup therefore requires BOTH the CRC32C and this 64-bit XXH64 to
// match — independent constructions, ~2^-96 combined. XXH64 (Yann
// Collet, BSD) is used because it runs near RAM speed on one core,
// so fusing it into the existing hash pass keeps staging disk-bound.

static const uint64_t kXxhP1 = 11400714785074694791ULL;
static const uint64_t kXxhP2 = 14029467366897019727ULL;
static const uint64_t kXxhP3 = 1609587929392839161ULL;
static const uint64_t kXxhP4 = 9650029242287828579ULL;
static const uint64_t kXxhP5 = 2870177450012600261ULL;

static inline uint64_t xxh_rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}
static inline uint64_t xxh_read64(const char* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
static inline uint32_t xxh_read32(const char* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
static inline uint64_t xxh_round(uint64_t acc, uint64_t lane) {
  acc += lane * kXxhP2;
  acc = xxh_rotl64(acc, 31);
  return acc * kXxhP1;
}
static inline uint64_t xxh_merge(uint64_t h, uint64_t v) {
  h ^= xxh_round(0, v);
  return h * kXxhP1 + kXxhP4;
}

// Streaming state: lets the fused tile pass feed 32-byte-aligned blocks
// while they are still L2-hot from the CRC pass, so RAM is read once.
struct Xxh64State {
  uint64_t v1, v2, v3, v4;
  uint64_t total;
  explicit Xxh64State(uint64_t seed)
      : v1(seed + kXxhP1 + kXxhP2),
        v2(seed + kXxhP2),
        v3(seed),
        v4(seed - kXxhP1),
        total(0) {}
};

// Consume the longest prefix of whole 32-byte stripes; returns bytes
// consumed. Interior blocks must be multiples of 32 so no tail buffering
// is needed between blocks.
static size_t xxh_consume_stripes(Xxh64State& s, const char* p, size_t n) {
  size_t consumed = 0;
  while (n - consumed >= 32) {
    s.v1 = xxh_round(s.v1, xxh_read64(p + consumed));
    s.v2 = xxh_round(s.v2, xxh_read64(p + consumed + 8));
    s.v3 = xxh_round(s.v3, xxh_read64(p + consumed + 16));
    s.v4 = xxh_round(s.v4, xxh_read64(p + consumed + 24));
    consumed += 32;
  }
  s.total += consumed;
  return consumed;
}

static uint64_t xxh_finalize(const Xxh64State& s, uint64_t seed,
                             const char* tail, size_t tail_n) {
  const uint64_t total = s.total + tail_n;
  uint64_t h;
  if (total >= 32) {
    h = xxh_rotl64(s.v1, 1) + xxh_rotl64(s.v2, 7) + xxh_rotl64(s.v3, 12) +
        xxh_rotl64(s.v4, 18);
    h = xxh_merge(h, s.v1);
    h = xxh_merge(h, s.v2);
    h = xxh_merge(h, s.v3);
    h = xxh_merge(h, s.v4);
  } else {
    h = seed + kXxhP5;
  }
  h += total;
  const char* p = tail;
  size_t n = tail_n;
  while (n >= 8) {
    h ^= xxh_round(0, xxh_read64(p));
    h = xxh_rotl64(h, 27) * kXxhP1 + kXxhP4;
    p += 8;
    n -= 8;
  }
  if (n >= 4) {
    h ^= static_cast<uint64_t>(xxh_read32(p)) * kXxhP1;
    h = xxh_rotl64(h, 23) * kXxhP2 + kXxhP3;
    p += 4;
    n -= 4;
  }
  while (n > 0) {
    h ^= static_cast<uint64_t>(static_cast<unsigned char>(*p)) * kXxhP5;
    h = xxh_rotl64(h, 11) * kXxhP1;
    ++p;
    --n;
  }
  h ^= h >> 33;
  h *= kXxhP2;
  h ^= h >> 29;
  h *= kXxhP3;
  h ^= h >> 32;
  return h;
}

uint64_t ts_xxh64(const void* buf, size_t n, uint64_t seed) {
  if (n == 0) {
    // Callers may pass NULL for empty input; `p + consumed` on a null
    // pointer is UB, so finalize the empty stream without touching it.
    Xxh64State s0(seed);
    static const char kEmpty = 0;
    return xxh_finalize(s0, seed, &kEmpty, 0);
  }
  const char* p = static_cast<const char*>(buf);
  Xxh64State s(seed);
  const size_t consumed = xxh_consume_stripes(s, p, n);
  return xxh_finalize(s, seed, p + consumed, n - consumed);
}

// Shared inner loop of the fused tile passes: hash one tile with both
// CRC32C and XXH64, optionally copying it to dst first. Processes
// 256 KiB blocks so the second hash reads each block while it is still
// cache-hot from the copy/first hash — one RAM read per byte total.
static void hash_tile_dual(char* dst, const char* src, size_t len,
                           uint32_t* crc_out, uint64_t* xxh_out) {
  const size_t kBlock = 256u << 10;  // multiple of 32 (stripe size)
  uint32_t crc = 0;
  Xxh64State s(0);
  size_t done = 0;
  while (done < len) {
    const size_t blk = (len - done < kBlock) ? (len - done) : kBlock;
    const char* hp = src + done;
    if (dst != nullptr) {
      std::memcpy(dst + done, src + done, blk);
      hp = dst + done;  // hash the copy while it is cache-hot
    }
    crc = ts_crc32c(hp, blk, crc);
    if (done + blk < len) {
      xxh_consume_stripes(s, hp, blk);  // interior blocks: 32-aligned
    } else {
      const size_t c = xxh_consume_stripes(s, hp, blk);
      *xxh_out = xxh_finalize(s, 0, hp + c, blk - c);
    }
    done += blk;
  }
  if (len == 0) *xxh_out = xxh_finalize(s, 0, src, 0);
  *crc_out = crc;
}

// Per-tile CRC32C + XXH64 of [src, src+n) in one memory pass (dst=NULL),
// or fused with a clone into dst (the async-snapshot staging path, where
// the defensive copy, the integrity CRC and the dedup hash would
// otherwise each read every byte). Tiles parallelize across nthreads.
static void crc_xxh_tiles_impl(void* dst, const void* src, size_t n,
                               size_t tile, uint32_t* crcs, uint64_t* xxhs,
                               int nthreads) {
  if (n == 0) return;
  if (tile == 0 || tile > n) tile = n;
  const size_t n_tiles = (n + tile - 1) / tile;
  std::atomic<size_t> next{0};
  auto work = [&] {
    for (;;) {
      const size_t i = next.fetch_add(1);
      if (i >= n_tiles) return;
      const size_t off = i * tile;
      const size_t len = (n - off < tile) ? (n - off) : tile;
      hash_tile_dual(
          dst == nullptr ? nullptr : static_cast<char*>(dst) + off,
          static_cast<const char*>(src) + off, len, &crcs[i], &xxhs[i]);
    }
  };
  if (nthreads <= 1 || n_tiles == 1 || n < (8u << 20)) {
    work();
    return;
  }
  const int nt = (static_cast<size_t>(nthreads) < n_tiles)
                     ? nthreads
                     : static_cast<int>(n_tiles);
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(work);
  for (auto& t : threads) t.join();
}

void ts_crc_xxh_tiles(const void* src, size_t n, size_t tile, uint32_t* crcs,
                      uint64_t* xxhs, int nthreads) {
  crc_xxh_tiles_impl(nullptr, src, n, tile, crcs, xxhs, nthreads);
}

void ts_memcpy_crc_xxh_tiles(void* dst, const void* src, size_t n, size_t tile,
                             uint32_t* crcs, uint64_t* xxhs, int nthreads) {
  crc_xxh_tiles_impl(dst, src, n, tile, crcs, xxhs, nthreads);
}

uint32_t ts_crc32c_combine(uint32_t crc1, uint32_t crc2, uint64_t len2) {
  (void)kShiftInit;
  if (len2 == 0) return crc1;
  for (int k = 0; len2; ++k, len2 >>= 1)
    if (len2 & 1) crc1 = gf2_matrix_times(kShiftMat[k], crc1);
  return crc1 ^ crc2;
}

// ---------------------------------------------------------------------------
// Dtype-aware fused tile compression.
//
// The engine's staging hot path already makes one fused memory pass per
// tile (clone + CRC32C + XXH64 above). On network-bound destinations
// (cloud, virtio, the write-back tier's remote drain) the storage pipe —
// not the host — is the ceiling, so a codec stage rides the same pass:
// a byte-shuffle filter keyed on dtype element size (bf16/f32/f64
// exponent bytes group into near-constant planes; fp8/int8 skip the
// filter) followed by LZ4 block compression, per checksum tile, so the
// restore path keeps tile-grain random access. The implementation is
// self-contained (the container ships no lz4/zstd library): a greedy
// hash-chain LZ4 block encoder and a bounds-checked decoder, both
// producing/consuming the standard LZ4 block format. Determinism is
// load-bearing: incremental dedup and salvage-resume compare hashes of
// the COMPRESSED bytes, so equal input must always yield equal output
// (fixed table size, greedy matching, no threads inside one tile).

static const size_t kLz4TableBits = 13;
static const size_t kLz4TableSize = 1u << kLz4TableBits;

static inline uint32_t lz4_read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

static inline uint32_t lz4_hash(uint32_t v) {
  return (v * 2654435761u) >> (32 - kLz4TableBits);
}

// Compress src[0..n) into dst[0..cap) (standard LZ4 block format).
// Returns the compressed size, or 0 when the output would reach ``cap``
// (caller stores the tile raw). ``table`` must hold kLz4TableSize
// uint32 slots; it is reset here (one memset per tile, reused across a
// thread's tiles).
static size_t lz4_compress_block(const uint8_t* src, size_t n, uint8_t* dst,
                                 size_t cap, uint32_t* table) {
  if (n == 0 || cap == 0) return 0;
  std::memset(table, 0, kLz4TableSize * sizeof(uint32_t));
  const uint8_t* ip = src;
  const uint8_t* anchor = src;
  const uint8_t* const iend = src + n;
  // Spec: the last match must start >= 12 bytes before the end, and the
  // last 5 bytes are always literals.
  const uint8_t* const mflimit = (n > 12) ? iend - 12 : src;
  const uint8_t* const matchlimit = iend - 5;
  uint8_t* op = dst;
  uint8_t* const oend = dst + cap;

  while (ip < mflimit) {
    const uint32_t v = lz4_read32(ip);
    const uint32_t h = lz4_hash(v);
    const uint8_t* ref = src + table[h];
    table[h] = static_cast<uint32_t>(ip - src);
    if (ref >= ip || static_cast<size_t>(ip - ref) > 65535 ||
        lz4_read32(ref) != v) {
      ++ip;
      continue;
    }
    // Extend the match forward.
    size_t mlen = 4;
    while (ip + mlen < matchlimit && ip[mlen] == ref[mlen]) ++mlen;
    const size_t litlen = static_cast<size_t>(ip - anchor);
    // Worst-case sequence size: token + litlen extras + literals +
    // offset + matchlen extras.
    const size_t need = 1 + litlen / 255 + 1 + litlen + 2 + mlen / 255 + 1;
    if (static_cast<size_t>(oend - op) < need) return 0;
    uint8_t* token = op++;
    if (litlen >= 15) {
      *token = 15 << 4;
      size_t rest = litlen - 15;
      while (rest >= 255) {
        *op++ = 255;
        rest -= 255;
      }
      *op++ = static_cast<uint8_t>(rest);
    } else {
      *token = static_cast<uint8_t>(litlen << 4);
    }
    std::memcpy(op, anchor, litlen);
    op += litlen;
    const size_t offset = static_cast<size_t>(ip - ref);
    *op++ = static_cast<uint8_t>(offset & 0xff);
    *op++ = static_cast<uint8_t>(offset >> 8);
    size_t mcode = mlen - 4;
    if (mcode >= 15) {
      *token |= 15;
      mcode -= 15;
      while (mcode >= 255) {
        *op++ = 255;
        mcode -= 255;
      }
      *op++ = static_cast<uint8_t>(mcode);
    } else {
      *token |= static_cast<uint8_t>(mcode);
    }
    ip += mlen;
    anchor = ip;
    if (ip < mflimit) {
      // Seed the table at the match tail so back-to-back matches chain.
      table[lz4_hash(lz4_read32(ip - 2))] =
          static_cast<uint32_t>(ip - 2 - src);
    }
  }
  // Final literals-only sequence.
  const size_t litlen = static_cast<size_t>(iend - anchor);
  const size_t need = 1 + litlen / 255 + 1 + litlen;
  if (static_cast<size_t>(oend - op) < need) return 0;
  uint8_t* token = op++;
  if (litlen >= 15) {
    *token = 15 << 4;
    size_t rest = litlen - 15;
    while (rest >= 255) {
      *op++ = 255;
      rest -= 255;
    }
    *op++ = static_cast<uint8_t>(rest);
  } else {
    *token = static_cast<uint8_t>(litlen << 4);
  }
  std::memcpy(op, anchor, litlen);
  op += litlen;
  return static_cast<size_t>(op - dst);
}

// Bounds-checked LZ4 block decode. Returns decompressed size or -1 on
// any malformed input (scrub catches bit-rot by CRC first; this guard
// is for defense in depth — corrupt input must never write out of
// bounds or loop forever).
static int64_t lz4_decompress_block(const uint8_t* src, size_t n,
                                    uint8_t* dst, size_t cap) {
  const uint8_t* ip = src;
  const uint8_t* const iend = src + n;
  uint8_t* op = dst;
  uint8_t* const oend = dst + cap;
  while (ip < iend) {
    const uint8_t token = *ip++;
    size_t litlen = token >> 4;
    if (litlen == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        litlen += b;
      } while (b == 255);
    }
    if (litlen > static_cast<size_t>(iend - ip) ||
        litlen > static_cast<size_t>(oend - op))
      return -1;
    std::memcpy(op, ip, litlen);
    op += litlen;
    ip += litlen;
    if (ip >= iend) break;  // last sequence carries no match
    if (iend - ip < 2) return -1;
    const size_t offset =
        static_cast<size_t>(ip[0]) | (static_cast<size_t>(ip[1]) << 8);
    ip += 2;
    if (offset == 0 || offset > static_cast<size_t>(op - dst)) return -1;
    size_t mlen = token & 15;
    if (mlen == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        mlen += b;
      } while (b == 255);
    }
    mlen += 4;
    if (mlen > static_cast<size_t>(oend - op)) return -1;
    const uint8_t* match = op - offset;
    if (offset >= mlen) {
      std::memcpy(op, match, mlen);
    } else {
      // Overlapping copy: forward byte order replicates the window
      // (RLE-style matches), exactly per the format.
      for (size_t i = 0; i < mlen; ++i) op[i] = match[i];
    }
    op += mlen;
  }
  return static_cast<int64_t>(op - dst);
}

// Byte-shuffle filter: split ``n`` bytes of ``elem``-sized values into
// ``elem`` byte planes (plane j = bytes j, j+elem, j+2*elem, ...). For
// float dtypes the exponent/sign bytes of nearby values are near
// constant, so their plane becomes long runs LZ4 folds away. A non-
// multiple tail rides raw after the planes.
static void byte_shuffle(const uint8_t* src, uint8_t* dst, size_t n,
                         int elem) {
  if (elem <= 1) {
    std::memcpy(dst, src, n);
    return;
  }
  const size_t ne = n / static_cast<size_t>(elem);
  for (int j = 0; j < elem; ++j) {
    uint8_t* d = dst + static_cast<size_t>(j) * ne;
    const uint8_t* s = src + j;
    for (size_t i = 0; i < ne; ++i) d[i] = s[i * elem];
  }
  const size_t body = ne * static_cast<size_t>(elem);
  std::memcpy(dst + body, src + body, n - body);
}

static void byte_unshuffle(const uint8_t* src, uint8_t* dst, size_t n,
                           int elem) {
  if (elem <= 1) {
    std::memcpy(dst, src, n);
    return;
  }
  const size_t ne = n / static_cast<size_t>(elem);
  for (int j = 0; j < elem; ++j) {
    const uint8_t* s = src + static_cast<size_t>(j) * ne;
    uint8_t* d = dst + j;
    for (size_t i = 0; i < ne; ++i) d[i * elem] = s[i];
  }
  const size_t body = ne * static_cast<size_t>(elem);
  std::memcpy(dst + body, src + body, n - body);
}

// Raw single-buffer entry points (unit tests, the Python policy's codec
// micro-benchmark). ``elem`` <= 1 skips the shuffle filter.
int64_t ts_lz4_compress(const void* src, size_t n, void* dst, size_t cap,
                        int elem) {
  std::vector<uint32_t> table(kLz4TableSize);
  const uint8_t* in = static_cast<const uint8_t*>(src);
  std::vector<uint8_t> shuffled;
  if (elem > 1 && n > 0) {
    shuffled.resize(n);
    byte_shuffle(in, shuffled.data(), n, elem);
    in = shuffled.data();
  }
  const size_t got = lz4_compress_block(in, n, static_cast<uint8_t*>(dst),
                                        cap, table.data());
  return got == 0 ? -1 : static_cast<int64_t>(got);
}

int64_t ts_lz4_decompress(const void* src, size_t n, void* dst, size_t cap,
                          int elem) {
  if (elem > 1 && cap > 0) {
    std::vector<uint8_t> shuffled(cap);
    const int64_t got = lz4_decompress_block(
        static_cast<const uint8_t*>(src), n, shuffled.data(), cap);
    if (got < 0) return got;
    byte_unshuffle(shuffled.data(), static_cast<uint8_t*>(dst),
                   static_cast<size_t>(got), elem);
    return got;
  }
  return lz4_decompress_block(static_cast<const uint8_t*>(src), n,
                              static_cast<uint8_t*>(dst), cap);
}

// Per-tile output slot: worst-case LZ4 expansion plus headroom, rounded
// so slots stay 64-byte aligned. The Python side sizes the destination
// buffer with ts_compress_bound (same formula — one definition each
// side of the FFI, asserted equal by the bindings at load time).
static size_t lz4_slot_stride(size_t tile) {
  const size_t bound = tile + tile / 255 + 64;
  return (bound + 63) & ~static_cast<size_t>(63);
}

int64_t ts_compress_bound(size_t n, size_t tile) {
  if (n == 0) return 0;
  if (tile == 0 || tile > n) tile = n;
  const size_t n_tiles = (n + tile - 1) / tile;
  return static_cast<int64_t>(n_tiles * lz4_slot_stride(tile));
}

// memmove + fused dual hash used by the compaction pass below: blocks
// stay cache-hot between the move and the two hash lanes, and forward
// block order makes the leftward overlapping move safe.
static void movehash_tile(uint8_t* dst, const uint8_t* src, size_t len,
                          uint32_t* crc_out, uint64_t* xxh_out,
                          int want_xxh) {
  const size_t kBlock = 256u << 10;  // multiple of the 32-byte stripe
  uint32_t crc = 0;
  Xxh64State s(0);
  size_t done = 0;
  while (done < len) {
    const size_t blk = (len - done < kBlock) ? (len - done) : kBlock;
    if (dst != src) std::memmove(dst + done, src + done, blk);
    crc = ts_crc32c(dst + done, blk, crc);
    if (want_xxh) {
      if (done + blk < len) {
        xxh_consume_stripes(s, reinterpret_cast<const char*>(dst + done),
                            blk);
      } else {
        const size_t c = xxh_consume_stripes(
            s, reinterpret_cast<const char*>(dst + done), blk);
        *xxh_out = xxh_finalize(
            s, 0, reinterpret_cast<const char*>(dst + done) + c, blk - c);
      }
    }
    done += blk;
  }
  if (want_xxh && len == 0)
    *xxh_out = xxh_finalize(s, 0, reinterpret_cast<const char*>(dst), 0);
  *crc_out = crc;
}

// Fused per-tile shuffle + LZ4 + dual hash over the COMPRESSED bytes —
// the compression analog of ts_memcpy_crc_xxh_tiles. Tiles compress in
// parallel into per-tile slots of ``dst`` (cap from ts_compress_bound),
// then one sequential compaction pass packs them contiguously while
// computing each tile's CRC32C (+ XXH64 when want_xxh) of the stored
// bytes — the values the manifest, the journal's salvage evidence and
// the upload journal all record, so the dual-hash rule holds unchanged
// over compressed blobs. A tile whose LZ4 output would not SHRINK it is
// stored raw (comp_size == raw tile size — the unambiguous marker the
// decoder keys on, since a stored LZ4 stream is always strictly
// smaller). Returns the total compressed size.
int64_t ts_compress_tiles(const void* src_, size_t n, size_t tile, int elem,
                          void* dst_, size_t dst_cap, int64_t* comp_sizes,
                          uint32_t* crcs, uint64_t* xxhs, int want_xxh,
                          int nthreads) {
  if (n == 0) return 0;
  if (tile == 0 || tile > n) tile = n;
  const size_t n_tiles = (n + tile - 1) / tile;
  const size_t stride = lz4_slot_stride(tile);
  if (dst_cap < n_tiles * stride) return -1;
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 16) nthreads = 16;
  const uint8_t* src = static_cast<const uint8_t*>(src_);
  uint8_t* dst = static_cast<uint8_t*>(dst_);
  std::atomic<size_t> next{0};
  auto work = [&] {
    std::vector<uint32_t> table(kLz4TableSize);
    std::vector<uint8_t> shuffled;
    if (elem > 1) shuffled.resize(tile);
    for (;;) {
      const size_t i = next.fetch_add(1);
      if (i >= n_tiles) return;
      const size_t off = i * tile;
      const size_t len = (n - off < tile) ? (n - off) : tile;
      const uint8_t* in = src + off;
      if (elem > 1) {
        byte_shuffle(in, shuffled.data(), len, elem);
        in = shuffled.data();
      }
      uint8_t* slot = dst + i * stride;
      // Cap at len - 1: output must be strictly smaller than the input
      // or the tile stores raw (the size-equality marker must stay
      // unambiguous).
      const size_t got =
          lz4_compress_block(in, len, slot, len > 0 ? len - 1 : 0,
                             table.data());
      if (got == 0) {
        std::memcpy(slot, src + off, len);  // raw: ORIGINAL bytes
        comp_sizes[i] = static_cast<int64_t>(len);
      } else {
        comp_sizes[i] = static_cast<int64_t>(got);
      }
    }
  };
  if (nthreads <= 1 || n_tiles == 1 || n < (8u << 20)) {
    work();
  } else {
    const int nt = (static_cast<size_t>(nthreads) < n_tiles)
                       ? nthreads
                       : static_cast<int>(n_tiles);
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int t = 0; t < nt; ++t) threads.emplace_back(work);
    for (auto& t : threads) t.join();
  }
  // Compaction + fused hash, strictly left-to-right (each tile's packed
  // offset is <= its slot offset, so the overlapping move is leftward).
  size_t out = 0;
  for (size_t i = 0; i < n_tiles; ++i) {
    const size_t len = static_cast<size_t>(comp_sizes[i]);
    uint64_t xxh = 0;
    movehash_tile(dst + out, dst + i * stride, len, &crcs[i], &xxh,
                  want_xxh);
    if (want_xxh) xxhs[i] = xxh;
    out += len;
  }
  return static_cast<int64_t>(out);
}

// Parallel tile decompress: the restore-side counterpart. ``src`` holds
// the concatenated compressed tiles (sizes in ``comp_sizes``); each
// decodes (LZ4 + unshuffle, or a raw copy when comp == raw size) into
// its row range of ``dst``. Returns total_raw, or -1 on malformed
// input/size mismatch (the caller surfaces a checksum-style error; the
// CRC over stored bytes has already vouched for transport integrity).
int64_t ts_decompress_tiles(const void* src_, size_t src_n,
                            const int64_t* comp_sizes, size_t n_tiles,
                            size_t tile_raw, size_t total_raw, void* dst_,
                            int elem, int nthreads) {
  if (n_tiles == 0) return total_raw == 0 ? 0 : -1;
  if (tile_raw == 0) tile_raw = total_raw;
  const uint8_t* src = static_cast<const uint8_t*>(src_);
  uint8_t* dst = static_cast<uint8_t*>(dst_);
  std::vector<size_t> offsets(n_tiles);
  size_t off = 0;
  for (size_t i = 0; i < n_tiles; ++i) {
    offsets[i] = off;
    if (comp_sizes[i] < 0) return -1;
    off += static_cast<size_t>(comp_sizes[i]);
  }
  if (off != src_n) return -1;
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 16) nthreads = 16;
  std::atomic<size_t> next{0};
  std::atomic<int> bad{0};
  auto work = [&] {
    std::vector<uint8_t> scratch;
    for (;;) {
      const size_t i = next.fetch_add(1);
      if (i >= n_tiles || bad.load()) return;
      const size_t raw_off = i * tile_raw;
      if (raw_off >= total_raw) {
        bad.store(1);
        return;
      }
      const size_t raw_len =
          (total_raw - raw_off < tile_raw) ? (total_raw - raw_off) : tile_raw;
      const uint8_t* in = src + offsets[i];
      const size_t clen = static_cast<size_t>(comp_sizes[i]);
      uint8_t* out = dst + raw_off;
      if (clen == raw_len) {
        std::memcpy(out, in, raw_len);  // stored raw
        continue;
      }
      if (clen > raw_len) {
        bad.store(1);
        return;
      }
      if (elem > 1) {
        if (scratch.size() < raw_len) scratch.resize(raw_len);
        const int64_t got =
            lz4_decompress_block(in, clen, scratch.data(), raw_len);
        if (got != static_cast<int64_t>(raw_len)) {
          bad.store(1);
          return;
        }
        byte_unshuffle(scratch.data(), out, raw_len, elem);
      } else {
        const int64_t got = lz4_decompress_block(in, clen, out, raw_len);
        if (got != static_cast<int64_t>(raw_len)) {
          bad.store(1);
          return;
        }
      }
    }
  };
  if (nthreads <= 1 || n_tiles == 1 || total_raw < (8u << 20)) {
    work();
  } else {
    const int nt = (static_cast<size_t>(nthreads) < n_tiles)
                       ? nthreads
                       : static_cast<int>(n_tiles);
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int t = 0; t < nt; ++t) threads.emplace_back(work);
    for (auto& t : threads) t.join();
  }
  if (bad.load()) return -1;
  return static_cast<int64_t>(total_raw);
}

}  // extern "C"
