// Copy of paddle_tpu/csrc/paddle_tpu_native.cpp: the host library of the port's
// fluid/native.py (no CUDA here).
//
// Native runtime components (C++), loaded from Python via ctypes.
//
// Reference counterparts:
//  - LoDTensor stream serialization: paddle/fluid/framework/tensor_util.cc
//    TensorToStream/TensorFromStream + lod_tensor.cc SerializeToStream
//    (format: u32 version, u64 lod_levels, per-level {u64 nbytes, u64
//    offsets[]}, u32 tensor version, i32 desc_size, VarType.TensorDesc
//    protobuf {field1 varint dtype, field2 packed varint dims}, raw data).
//    Byte-identical to the Python implementation in fluid/ops/io_ops.py.
//  - Blocking queue: paddle/fluid/operators/reader/lod_tensor_blocking_queue.h
//    (bounded, close semantics) — backs the DataLoader producer thread.
//  - MultiSlot parser: paddle/fluid/framework/data_feed.cc
//    MultiSlotDataFeed::ParseOneInstance (per line, per slot: count then
//    values; slot type uint64 ids or float).
//
// Everything is handle-based extern "C" so ctypes needs no C++ ABI.

#include <cctype>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <vector>

extern "C" {

void pt_free(void* p) { std::free(p); }

// ---------------------------------------------------------------------------
// Blocking byte-blob queue
// ---------------------------------------------------------------------------
struct PtQueue {
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::deque<std::vector<uint8_t>> items;
  size_t capacity;
  bool closed = false;
};

void* pt_queue_create(uint64_t capacity) {
  auto* q = new PtQueue();
  q->capacity = capacity ? capacity : 1;
  return q;
}

// returns 0 ok, 1 timeout, 2 closed
int pt_queue_push(void* h, const uint8_t* data, uint64_t len, int timeout_ms) {
  auto* q = static_cast<PtQueue*>(h);
  std::unique_lock<std::mutex> lk(q->mu);
  auto ready = [q] { return q->closed || q->items.size() < q->capacity; };
  if (timeout_ms < 0) {
    q->cv_push.wait(lk, ready);
  } else if (!q->cv_push.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                  ready)) {
    return 1;
  }
  if (q->closed) return 2;
  q->items.emplace_back(data, data + len);
  q->cv_pop.notify_one();
  return 0;
}

// returns 0 ok (out malloc'd, caller pt_free), 1 timeout, 2 closed+empty
int pt_queue_pop(void* h, uint8_t** out, uint64_t* out_len, int timeout_ms) {
  auto* q = static_cast<PtQueue*>(h);
  std::unique_lock<std::mutex> lk(q->mu);
  auto ready = [q] { return q->closed || !q->items.empty(); };
  if (timeout_ms < 0) {
    q->cv_pop.wait(lk, ready);
  } else if (!q->cv_pop.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                 ready)) {
    return 1;
  }
  if (q->items.empty()) return 2;  // closed and drained
  auto& front = q->items.front();
  *out_len = front.size();
  *out = static_cast<uint8_t*>(std::malloc(front.size()));
  std::memcpy(*out, front.data(), front.size());
  q->items.pop_front();
  q->cv_push.notify_one();
  return 0;
}

void pt_queue_close(void* h) {
  auto* q = static_cast<PtQueue*>(h);
  {
    std::lock_guard<std::mutex> lk(q->mu);
    q->closed = true;
  }
  q->cv_push.notify_all();
  q->cv_pop.notify_all();
}

uint64_t pt_queue_size(void* h) {
  auto* q = static_cast<PtQueue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  return q->items.size();
}

void pt_queue_destroy(void* h) { delete static_cast<PtQueue*>(h); }

// ---------------------------------------------------------------------------
// LoDTensor stream serialization
// ---------------------------------------------------------------------------
static void put_varint(std::vector<uint8_t>& out, uint64_t v) {
  while (true) {
    uint8_t bits = v & 0x7F;
    v >>= 7;
    if (v) {
      out.push_back(bits | 0x80);
    } else {
      out.push_back(bits);
      return;
    }
  }
}

static int get_varint(const uint8_t* buf, uint64_t len, uint64_t* pos,
                      uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (*pos < len) {
    uint8_t b = buf[(*pos)++];
    result |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = result;
      return 0;
    }
    shift += 7;
  }
  return -1;
}

static void put_bytes(std::vector<uint8_t>& out, const void* v, size_t n) {
  const uint8_t* p = static_cast<const uint8_t*>(v);
  out.insert(out.end(), p, p + n);
}
static void put_u32(std::vector<uint8_t>& out, uint32_t v) { put_bytes(out, &v, 4); }
static void put_u64(std::vector<uint8_t>& out, uint64_t v) { put_bytes(out, &v, 8); }
static void put_i32(std::vector<uint8_t>& out, int32_t v) { put_bytes(out, &v, 4); }

// serialize; *out is malloc'd, caller pt_free
int pt_tensor_serialize(int dtype_enum, int ndim, const int64_t* dims,
                        const uint8_t* data, uint64_t nbytes, int lod_levels,
                        const uint64_t* lod_level_lens,
                        const uint64_t* lod_flat, uint8_t** out,
                        uint64_t* out_len) {
  std::vector<uint8_t> buf;
  buf.reserve(nbytes + 128);
  put_u32(buf, 0);                      // version
  put_u64(buf, (uint64_t)lod_levels);   // lod level count
  uint64_t flat = 0;
  for (int i = 0; i < lod_levels; i++) {
    put_u64(buf, lod_level_lens[i] * 8);  // level nbytes
    const uint8_t* p = reinterpret_cast<const uint8_t*>(lod_flat + flat);
    buf.insert(buf.end(), p, p + lod_level_lens[i] * 8);
    flat += lod_level_lens[i];
  }
  put_u32(buf, 0);  // tensor version
  // TensorDesc proto: field 1 varint dtype, field 2 length-delimited packed dims
  std::vector<uint8_t> desc;
  desc.push_back(0x08);
  put_varint(desc, (uint64_t)dtype_enum);
  std::vector<uint8_t> dims_payload;
  for (int i = 0; i < ndim; i++) put_varint(dims_payload, (uint64_t)dims[i]);
  desc.push_back(0x12);
  put_varint(desc, dims_payload.size());
  desc.insert(desc.end(), dims_payload.begin(), dims_payload.end());
  put_i32(buf, (int32_t)desc.size());
  buf.insert(buf.end(), desc.begin(), desc.end());
  buf.insert(buf.end(), data, data + nbytes);

  *out = static_cast<uint8_t*>(std::malloc(buf.size()));
  std::memcpy(*out, buf.data(), buf.size());
  *out_len = buf.size();
  return 0;
}

struct PtTensor {
  int dtype_enum = -1;
  std::vector<int64_t> dims;
  std::vector<uint8_t> data;
  std::vector<std::vector<uint64_t>> lod;
  uint64_t consumed = 0;
};

static uint64_t dtype_size(int dtype_enum) {
  switch (dtype_enum) {
    case 0: return 1;   // BOOL
    case 1: return 2;   // INT16
    case 2: return 4;   // INT32
    case 3: return 8;   // INT64
    case 4: return 2;   // FP16
    case 5: return 4;   // FP32
    case 6: return 8;   // FP64
    case 20: return 1;  // UINT8
    case 21: return 1;  // INT8
    case 22: return 2;  // BF16
    default: return 0;
  }
}

void* pt_tensor_read(const uint8_t* buf, uint64_t len) {
  auto t = new PtTensor();
  uint64_t pos = 0;
  auto fail = [&]() -> void* {
    delete t;
    return nullptr;
  };
  if (pos + 4 > len) return fail();
  uint32_t version;
  std::memcpy(&version, buf + pos, 4);
  pos += 4;
  if (version != 0) return fail();
  if (pos + 8 > len) return fail();
  uint64_t lod_levels;
  std::memcpy(&lod_levels, buf + pos, 8);
  pos += 8;
  for (uint64_t i = 0; i < lod_levels; i++) {
    if (pos + 8 > len) return fail();
    uint64_t nbytes;
    std::memcpy(&nbytes, buf + pos, 8);
    pos += 8;
    if (pos + nbytes > len) return fail();
    std::vector<uint64_t> level(nbytes / 8);
    std::memcpy(level.data(), buf + pos, nbytes);
    pos += nbytes;
    t->lod.push_back(std::move(level));
  }
  if (pos + 4 > len) return fail();
  uint32_t tversion;
  std::memcpy(&tversion, buf + pos, 4);
  pos += 4;
  if (tversion != 0) return fail();
  if (pos + 4 > len) return fail();
  int32_t desc_size;
  std::memcpy(&desc_size, buf + pos, 4);
  pos += 4;
  uint64_t desc_end = pos + (uint64_t)desc_size;
  if (desc_end > len) return fail();
  while (pos < desc_end) {
    uint64_t tag;
    if (get_varint(buf, desc_end, &pos, &tag)) return fail();
    uint64_t field = tag >> 3, wire = tag & 7;
    if (field == 1 && wire == 0) {
      uint64_t v;
      if (get_varint(buf, desc_end, &pos, &v)) return fail();
      t->dtype_enum = (int)v;
    } else if (field == 2 && wire == 2) {
      uint64_t ln;
      if (get_varint(buf, desc_end, &pos, &ln)) return fail();
      uint64_t end2 = pos + ln;
      while (pos < end2) {
        uint64_t d;
        if (get_varint(buf, end2, &pos, &d)) return fail();
        t->dims.push_back((int64_t)d);
      }
    } else if (field == 2 && wire == 0) {
      uint64_t d;
      if (get_varint(buf, desc_end, &pos, &d)) return fail();
      t->dims.push_back((int64_t)d);
    } else {
      return fail();
    }
  }
  uint64_t count = 1;
  for (auto d : t->dims) count *= (uint64_t)d;
  uint64_t esize = dtype_size(t->dtype_enum);
  if (!esize) return fail();
  uint64_t nbytes = count * esize;
  if (pos + nbytes > len) return fail();
  t->data.assign(buf + pos, buf + pos + nbytes);
  pos += nbytes;
  t->consumed = pos;
  return t;
}

int pt_tensor_dtype(void* h) { return static_cast<PtTensor*>(h)->dtype_enum; }
int pt_tensor_ndim(void* h) {
  return (int)static_cast<PtTensor*>(h)->dims.size();
}
const int64_t* pt_tensor_dims(void* h) {
  return static_cast<PtTensor*>(h)->dims.data();
}
const uint8_t* pt_tensor_data(void* h) {
  return static_cast<PtTensor*>(h)->data.data();
}
uint64_t pt_tensor_nbytes(void* h) {
  return static_cast<PtTensor*>(h)->data.size();
}
uint64_t pt_tensor_consumed(void* h) {
  return static_cast<PtTensor*>(h)->consumed;
}
int pt_tensor_lod_levels(void* h) {
  return (int)static_cast<PtTensor*>(h)->lod.size();
}
uint64_t pt_tensor_lod_level_len(void* h, int i) {
  return static_cast<PtTensor*>(h)->lod[i].size();
}
const uint64_t* pt_tensor_lod_level(void* h, int i) {
  return static_cast<PtTensor*>(h)->lod[i].data();
}
void pt_tensor_destroy(void* h) { delete static_cast<PtTensor*>(h); }

// ---------------------------------------------------------------------------
// MultiSlot data-feed parser
// ---------------------------------------------------------------------------
// File format (reference data_feed.cc MultiSlotDataFeed): one instance per
// line; for each slot in order: "<count> <v1> ... <vcount>". Slot values are
// uint64 ids (sparse) or float (dense).
struct PtMultiSlot {
  int num_slots = 0;
  uint64_t num_lines = 0;
  // per slot: concatenated values; offsets[line] .. offsets[line+1] slices
  std::vector<std::vector<int64_t>> ints;
  std::vector<std::vector<float>> floats;
  std::vector<std::vector<uint64_t>> offsets;
  std::vector<int> is_float;
};

void* pt_multislot_parse(const char* path, int num_slots,
                         const int* is_float) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  auto* ms = new PtMultiSlot();
  ms->num_slots = num_slots;
  ms->is_float.assign(is_float, is_float + num_slots);
  ms->ints.resize(num_slots);
  ms->floats.resize(num_slots);
  ms->offsets.assign(num_slots, {0});

  std::string line;
  char chunk[1 << 16];
  std::string content;
  size_t got;
  while ((got = std::fread(chunk, 1, sizeof(chunk), f)) > 0)
    content.append(chunk, got);
  std::fclose(f);

  size_t p = 0, n = content.size();
  auto skip_ws = [&](size_t& i) {
    while (i < n && (content[i] == ' ' || content[i] == '\t')) i++;
  };
  bool ok = true;
  while (p < n) {
    size_t eol = content.find('\n', p);
    if (eol == std::string::npos) eol = n;
    // NUL-terminate the line so strtol/strtof cannot skip the newline and
    // consume tokens from the next instance (short lines must FAIL, not
    // silently misalign slots)
    char saved = eol < n ? content[eol] : '\0';
    if (eol < n) content[eol] = '\0';
    size_t i = p;
    bool blank = true;
    for (size_t j = p; j < eol; j++)
      if (!isspace((unsigned char)content[j])) blank = false;
    if (!blank) {
      for (int s = 0; s < num_slots && ok; s++) {
        skip_ws(i);
        char* endp = nullptr;
        long cnt = std::strtol(content.data() + i, &endp, 10);
        if (endp == content.data() + i || cnt < 0) {
          ok = false;
          break;
        }
        i = endp - content.data();
        for (long k = 0; k < cnt; k++) {
          skip_ws(i);
          if (ms->is_float[s]) {
            float v = std::strtof(content.data() + i, &endp);
            if (endp == content.data() + i) {
              ok = false;
              break;
            }
            ms->floats[s].push_back(v);
          } else {
            // ids are uint64 in the format (hash features exceed 2^63);
            // stored in the int64 buffer bit-for-bit
            unsigned long long v =
                std::strtoull(content.data() + i, &endp, 10);
            if (endp == content.data() + i) {
              ok = false;
              break;
            }
            ms->ints[s].push_back((int64_t)v);
          }
          i = endp - content.data();
        }
        ms->offsets[s].push_back(
            ms->is_float[s] ? ms->floats[s].size() : ms->ints[s].size());
      }
      if (ok) {
        // trailing garbage after the last slot is a malformed instance
        skip_ws(i);
        if (i < eol && content[i] != '\0') ok = false;
      }
      if (!ok) {
        if (eol < n) content[eol] = saved;
        break;
      }
      ms->num_lines++;
    }
    if (eol < n) content[eol] = saved;
    p = eol + 1;
  }
  if (!ok) {
    delete ms;
    return nullptr;
  }
  return ms;
}

uint64_t pt_ms_num_lines(void* h) {
  return static_cast<PtMultiSlot*>(h)->num_lines;
}
const uint64_t* pt_ms_offsets(void* h, int slot) {
  return static_cast<PtMultiSlot*>(h)->offsets[slot].data();
}
const int64_t* pt_ms_ints(void* h, int slot) {
  return static_cast<PtMultiSlot*>(h)->ints[slot].data();
}
const float* pt_ms_floats(void* h, int slot) {
  return static_cast<PtMultiSlot*>(h)->floats[slot].data();
}
uint64_t pt_ms_total(void* h, int slot) {
  auto* ms = static_cast<PtMultiSlot*>(h);
  return ms->is_float[slot] ? ms->floats[slot].size()
                            : ms->ints[slot].size();
}
void pt_ms_destroy(void* h) { delete static_cast<PtMultiSlot*>(h); }

}  // extern "C"
