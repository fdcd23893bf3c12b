// mmap ring-buffer trace store — the native backing for span recording.
//
// Role: the reference records spans with fire-and-forget queueMicrotask
// writes into browser storage (traceCollectorService.ts); its upstream
// native deps use @vscode/sqlite3 + spdlog for the same job (SURVEY.md
// §2.6). Here the hot path is a fixed-slot mmap ring: appending a span is
// one memcpy under a mutex — no allocation, no syscall after setup — and
// the file survives process crashes for WAL-style recovery.
//
// Layout: 64-byte header {magic, slot_size, n_slots, head, dropped},
// then n_slots fixed-size slots, each {u32 len, bytes}. head is the
// total number of appends ever; slot index = head % n_slots. Readers can
// fetch any record still inside the window [head - n_slots, head).
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <mutex>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x53574e4152494e47ULL;  // "SWNARING"

struct Header {
  uint64_t magic;
  uint64_t slot_size;   // bytes per slot, including the u32 length prefix
  uint64_t n_slots;
  uint64_t head;        // total appends ever
  uint64_t dropped;     // appends rejected for being oversized
  uint64_t reserved[3];
};

struct Ring {
  int fd = -1;
  uint8_t* base = nullptr;
  uint64_t file_size = 0;
  Header* hdr = nullptr;
  std::mutex mu;

  uint8_t* slot(uint64_t i) {
    return base + sizeof(Header) + (i % hdr->n_slots) * hdr->slot_size;
  }
};

}  // namespace

extern "C" {

void* ring_create(const char* path, uint64_t slot_size, uint64_t n_slots) {
  if (slot_size < 8 || n_slots == 0) return nullptr;
  uint64_t file_size = sizeof(Header) + slot_size * n_slots;
  int fd = ::open(path, O_RDWR | O_CREAT, 0644);
  if (fd < 0) return nullptr;
  if (::ftruncate(fd, (off_t)file_size) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* base =
      ::mmap(nullptr, file_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* ring = new Ring();
  ring->fd = fd;
  ring->base = static_cast<uint8_t*>(base);
  ring->file_size = file_size;
  ring->hdr = reinterpret_cast<Header*>(base);
  if (ring->hdr->magic != kMagic || ring->hdr->slot_size != slot_size ||
      ring->hdr->n_slots != n_slots) {
    // Fresh (or incompatible) file: initialize.
    std::memset(base, 0, sizeof(Header));
    ring->hdr->magic = kMagic;
    ring->hdr->slot_size = slot_size;
    ring->hdr->n_slots = n_slots;
  }
  return ring;
}

void* ring_open(const char* path) {
  int fd = ::open(path, O_RDWR);
  if (fd < 0) return nullptr;
  struct stat st;
  if (::fstat(fd, &st) != 0 || (uint64_t)st.st_size < sizeof(Header)) {
    ::close(fd);
    return nullptr;
  }
  void* base = ::mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                      MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* hdr = reinterpret_cast<Header*>(base);
  if (hdr->magic != kMagic ||
      sizeof(Header) + hdr->slot_size * hdr->n_slots != (uint64_t)st.st_size) {
    ::munmap(base, (size_t)st.st_size);
    ::close(fd);
    return nullptr;
  }
  auto* ring = new Ring();
  ring->fd = fd;
  ring->base = static_cast<uint8_t*>(base);
  ring->file_size = (uint64_t)st.st_size;
  ring->hdr = hdr;
  return ring;
}

// Returns the record's global index (>= 0), or -1 if data is too large.
int64_t ring_append(void* handle, const void* data, uint32_t len) {
  auto* ring = static_cast<Ring*>(handle);
  std::lock_guard<std::mutex> lock(ring->mu);
  if (len + sizeof(uint32_t) > ring->hdr->slot_size) {
    ring->hdr->dropped++;
    return -1;
  }
  uint64_t idx = ring->hdr->head;
  uint8_t* s = ring->slot(idx);
  std::memcpy(s, &len, sizeof(uint32_t));
  std::memcpy(s + sizeof(uint32_t), data, len);
  ring->hdr->head = idx + 1;
  return (int64_t)idx;
}

uint64_t ring_head(void* handle) {
  return static_cast<Ring*>(handle)->hdr->head;
}

uint64_t ring_dropped(void* handle) {
  return static_cast<Ring*>(handle)->hdr->dropped;
}

uint64_t ring_capacity(void* handle) {
  return static_cast<Ring*>(handle)->hdr->n_slots;
}

// Copies record idx into buf; returns its length, -1 if evicted/invalid,
// -2 if buf too small.
int64_t ring_read(void* handle, uint64_t idx, void* buf, uint32_t buflen) {
  auto* ring = static_cast<Ring*>(handle);
  std::lock_guard<std::mutex> lock(ring->mu);
  uint64_t head = ring->hdr->head;
  uint64_t n = ring->hdr->n_slots;
  if (idx >= head || idx + n < head) return -1;
  uint8_t* s = ring->slot(idx);
  uint32_t len;
  std::memcpy(&len, s, sizeof(uint32_t));
  if (len > buflen) return -2;
  std::memcpy(buf, s + sizeof(uint32_t), len);
  return (int64_t)len;
}

void ring_close(void* handle) {
  auto* ring = static_cast<Ring*>(handle);
  ::msync(ring->base, ring->file_size, MS_ASYNC);
  ::munmap(ring->base, ring->file_size);
  ::close(ring->fd);
  delete ring;
}

// ---- batched byte-level tokenization (host data loader hot path) ----
//
// Encodes n UTF-8 strings into a padded (n, max_len) int32 matrix in one
// call: ids 0-255 = bytes (ByteTokenizer contract, models/tokenizer.py),
// optional BOS, PAD fill. out_lens receives true lengths. Returns 0.
int byte_tokenize_batch(const char** texts, const int32_t* text_lens,
                        int32_t n, int32_t max_len, int32_t bos_id,
                        int32_t pad_id, int32_t* out, int32_t* out_lens) {
  for (int32_t i = 0; i < n; ++i) {
    int32_t* row = out + (int64_t)i * max_len;
    int32_t pos = 0;
    if (bos_id >= 0 && pos < max_len) row[pos++] = bos_id;
    const uint8_t* t = reinterpret_cast<const uint8_t*>(texts[i]);
    int32_t tlen = text_lens[i];
    for (int32_t j = 0; j < tlen && pos < max_len; ++j) row[pos++] = t[j];
    out_lens[i] = pos;
    for (; pos < max_len; ++pos) row[pos] = pad_id;
  }
  return 0;
}

}  // extern "C"
