// Copy of paddle_tpu/csrc/rpc.cpp: the host library of the port's
// fluid/native.py (no CUDA here).
//
// Parameter-server RPC transport (C++), loaded from Python via ctypes.
//
// Reference counterparts:
//  - RPCServer / RPCClient abstraction: paddle/fluid/operators/distributed/
//    rpc_server.h, rpc_client.h (gRPC backend grpc/grpc_server.cc,
//    grpc_client.cc; BRPC backend brpc/*).
//  - Request kinds: SEND / GET / barriers / COMPLETE — the handler set of
//    request_handler_impl.cc (RequestSendHandler, RequestGetHandler) plus the
//    barrier accounting of rpc_server.cc (IncreaseBatchBarrier,
//    WaitBarrier) and Executor::Close -> SendComplete (executor.cc:110).
//
// Design notes: the pserver path rides the host network, so
// no accelerator types appear here — payloads are opaque byte blobs in the
// LoDTensor stream format (paddle_tpu_native.cpp pt_tensor_serialize).
// Framing is a fixed little-endian header instead of gRPC: one dependency
// fewer, identical semantics. Sync-mode step accounting is per-trainer
// monotonic barrier counters (not resettable globals) so a fast trainer that
// starts step s+1 while a slow one is still fetching step s cannot corrupt
// the stage machine.
//
// Wire protocol, all little-endian:
//   request:  u8 opcode | u32 trainer_id | u64 seq | u32 name_len
//             | name bytes | u64 payload_len | payload
//   response: u8 status (0 ok, 1 not-found, 2 shutdown) | u64 payload_len
//             | payload
//
// seq is a client-assigned per-logical-operation id (0 = read-only, not
// tracked; clients seed randomly and increment). Mutating ops
// (SEND/barriers/COMPLETE/CHECKPOINT) are deduped server-side against a
// bounded per-trainer window of recently applied seqs, making the client's
// deadline-retry loop safe: a retry after an ambiguous failure (request
// applied but the response lost to SO_RCVTIMEO) re-sends the same seq and
// is acked without being applied twice — a duplicated send_barrier would
// otherwise wedge the sync-mode kGetVar wait predicate, and a duplicated
// async send_var would double-apply a gradient.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <vector>

namespace {

enum Opcode : uint8_t {
  kSendVar = 1,
  kGetVar = 2,
  kSendBarrier = 3,
  kFetchBarrier = 4,
  kComplete = 5,
  // sparse-table row fetch (reference: request_handler_impl.cc
  // RequestPrefetchHandler + parameter_prefetch.cc): name = table name,
  // payload = raw little-endian int64 LOCAL row ids; response = the
  // concatenated raw row bytes from the registered table buffer.
  kPrefetch = 6,
  // checkpoint-on-demand (reference: checkpoint_notify_op.cc +
  // request_handler_impl.cc RequestCheckpointHandler): name = directory.
  kCheckpointNotify = 7,
};

int64_t steady_ms() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

bool write_full(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n) {
    ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
    if (w <= 0) return false;
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool read_full(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

struct Request {
  uint8_t opcode;
  uint32_t trainer_id;
  uint64_t seq = 0;
  std::string name;
  std::vector<uint8_t> payload;
};

bool read_request(int fd, Request* req) {
  uint8_t op;
  uint32_t tid, name_len;
  uint64_t seq, payload_len;
  if (!read_full(fd, &op, 1)) return false;
  if (!read_full(fd, &tid, 4)) return false;
  if (!read_full(fd, &seq, 8)) return false;
  if (!read_full(fd, &name_len, 4)) return false;
  if (name_len > (64u << 10)) return false;
  req->name.resize(name_len);
  if (name_len && !read_full(fd, &req->name[0], name_len)) return false;
  if (!read_full(fd, &payload_len, 8)) return false;
  if (payload_len > (8ull << 30)) return false;
  req->payload.resize(payload_len);
  if (payload_len && !read_full(fd, req->payload.data(), payload_len))
    return false;
  req->opcode = op;
  req->trainer_id = tid;
  req->seq = seq;
  return true;
}

bool write_response(int fd, uint8_t status, const uint8_t* payload,
                    uint64_t len) {
  if (!write_full(fd, &status, 1)) return false;
  if (!write_full(fd, &len, 8)) return false;
  if (len && !write_full(fd, payload, len)) return false;
  return true;
}

struct RpcServer {
  int listen_fd = -1;
  int port = 0;
  int n_trainers = 1;
  bool sync_mode = true;

  std::mutex mu;
  std::condition_variable cv;
  // received vars (grads), keyed "name@trainer_<i>" in sync mode
  std::map<std::string, std::vector<uint8_t>> recv_store;
  // served vars (params), published by the Python optimize loop
  std::map<std::string, std::vector<uint8_t>> param_store;
  // per-trainer monotonic barrier counters (see header comment)
  std::vector<uint64_t> send_counts, fetch_counts;
  std::vector<uint8_t> completed;
  uint64_t step = 0;     // completed optimize rounds
  bool serving = false;  // params for `step` published, GETs may proceed
  bool shutting_down = false;
  // async mode: FIFO of received (name, trainer, payload)
  std::deque<Request> async_q;
  // sparse tables served by kPrefetch: raw row-major buffer + row stride
  struct Table {
    std::vector<uint8_t> data;
    uint64_t row_bytes = 0;
  };
  std::map<std::string, Table> table_store;
  // checkpoint_notify queue (directory names)
  std::deque<std::string> notify_q;
  // worker liveness: last request timestamp per trainer (HeartBeatMonitor,
  // operators/distributed/heart_beat_monitor.h:54 — sends count as beats)
  std::vector<int64_t> last_active_ms;
  // retry-dedup: bounded window of recently applied mutating-op seqs per
  // trainer. Exact-match (not a high-water mark) so correctness needs only
  // seq UNIQUENESS — concurrent client threads may transmit out of
  // allocation order, and a restarted trainer reseeds randomly, neither of
  // which may cause a live op to be mistaken for a duplicate.
  struct SeqWindow {
    std::deque<uint64_t> order;
    std::set<uint64_t> seen;       // applied (ack of a dup is safe)
    std::set<uint64_t> in_flight;  // checked-in but not yet applied
  };
  std::vector<SeqWindow> seq_windows;
  static constexpr size_t kSeqWindowCap = 4096;

  // mark a mutating op applied: retries blocked in the in-flight wait may
  // now be acked (an ack must IMPLY the apply happened — ack-before-apply
  // would let a retried send_barrier satisfy the sync predicate while the
  // original gradient store is still pending on a descheduled thread)
  void seq_applied(uint32_t t, uint64_t seq) {
    if (!seq) return;
    {
      std::lock_guard<std::mutex> lk(mu);
      SeqWindow& w = seq_windows[t];
      w.in_flight.erase(seq);
      if (!w.seen.count(seq)) {
        w.seen.insert(seq);
        w.order.push_back(seq);
        if (w.order.size() > kSeqWindowCap) {
          w.seen.erase(w.order.front());
          w.order.pop_front();
        }
      }
    }
    cv.notify_all();
  }

  std::thread accept_thread;
  std::vector<std::thread> conn_threads;

  bool all_complete_locked() const {
    for (auto c : completed)
      if (!c) return false;
    return true;
  }

  void handle_conn(int fd) {
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    Request req;
    uint32_t t = 0;
    while (read_request(fd, &req)) {
      // an out-of-range trainer_id must NOT alias trainer 0 (it would both
      // beat 0's heartbeat and corrupt barrier accounting) — drop the conn
      if (req.trainer_id >= (uint32_t)n_trainers) goto done;
      t = req.trainer_id;
      {
        std::lock_guard<std::mutex> lk(mu);
        last_active_ms[t] = steady_ms();
      }
      {
        // retry dedup: a mutating op whose seq was already applied (the
        // client re-sent it after losing the response to its deadline) is
        // acked without being applied again; a retry racing the ORIGINAL's
        // in-flight apply waits for it, so an ack always implies applied.
        // The window is bounded; a client retry always lands within a
        // handful of intervening ops.
        bool mutating = req.opcode == kSendVar || req.opcode == kSendBarrier ||
                        req.opcode == kFetchBarrier ||
                        req.opcode == kComplete ||
                        req.opcode == kCheckpointNotify;
        if (mutating && req.seq != 0) {
          std::unique_lock<std::mutex> lk(mu);
          SeqWindow& w = seq_windows[t];
          bool duplicate = false;
          if (w.seen.count(req.seq)) {
            duplicate = true;
          } else if (w.in_flight.count(req.seq)) {
            cv.wait(lk, [&] {
              return shutting_down || w.seen.count(req.seq) > 0;
            });
            if (!w.seen.count(req.seq)) {
              // woken by shutdown BEFORE the original applied: a success
              // ack here would break ack-implies-applied — report shutdown
              // like the kGetVar path does
              lk.unlock();
              write_response(fd, 2, nullptr, 0);
              goto done;
            }
            duplicate = true;
          } else {
            w.in_flight.insert(req.seq);
          }
          if (duplicate) {
            lk.unlock();
            if (!write_response(fd, 0, nullptr, 0)) goto done;
            continue;
          }
        }
      }
      switch (req.opcode) {
        case kSendVar: {
          std::unique_lock<std::mutex> lk(mu);
          if (sync_mode) {
            recv_store[req.name + "@trainer_" + std::to_string(t)] =
                std::move(req.payload);
          } else {
            async_q.push_back(req);
          }
          cv.notify_all();
          lk.unlock();
          seq_applied(t, req.seq);
          if (!write_response(fd, 0, nullptr, 0)) goto done;
          break;
        }
        case kGetVar: {
          std::unique_lock<std::mutex> lk(mu);
          if (sync_mode) {
            // A trainer that has not sent this round (send_counts == step,
            // e.g. the startup-program param pull) reads current params
            // immediately; one that has sent (send_counts == step+1) waits
            // for this step's optimize to publish; one running further
            // ahead blocks instead of reading stale params.
            cv.wait(lk, [&] {
              return shutting_down || completed[t] ||
                     send_counts[t] == step ||
                     (serving && send_counts[t] == step + 1);
            });
          } else {
            cv.wait(lk, [&] {
              return shutting_down || param_store.count(req.name) > 0;
            });
          }
          if (shutting_down) {
            write_response(fd, 2, nullptr, 0);
            goto done;
          }
          auto it = param_store.find(req.name);
          if (it == param_store.end()) {
            lk.unlock();
            if (!write_response(fd, 1, nullptr, 0)) goto done;
          } else {
            std::vector<uint8_t> copy = it->second;
            lk.unlock();
            if (!write_response(fd, 0, copy.data(), copy.size())) goto done;
          }
          break;
        }
        case kSendBarrier: {
          {
            std::lock_guard<std::mutex> lk(mu);
            send_counts[t]++;
          }
          cv.notify_all();
          seq_applied(t, req.seq);
          if (!write_response(fd, 0, nullptr, 0)) goto done;
          break;
        }
        case kFetchBarrier: {
          {
            std::lock_guard<std::mutex> lk(mu);
            fetch_counts[t]++;
          }
          cv.notify_all();
          seq_applied(t, req.seq);
          if (!write_response(fd, 0, nullptr, 0)) goto done;
          break;
        }
        case kComplete: {
          {
            std::lock_guard<std::mutex> lk(mu);
            completed[t] = 1;
          }
          cv.notify_all();
          seq_applied(t, req.seq);
          if (!write_response(fd, 0, nullptr, 0)) goto done;
          break;
        }
        case kPrefetch: {
          std::vector<uint8_t> rows;
          uint8_t status = 0;
          {
            std::lock_guard<std::mutex> lk(mu);
            auto it = table_store.find(req.name);
            if (it == table_store.end() || it->second.row_bytes == 0 ||
                req.payload.size() % 8 != 0) {
              status = 1;
            } else {
              const Table& tab = it->second;
              uint64_t n_ids = req.payload.size() / 8;
              uint64_t n_rows = tab.data.size() / tab.row_bytes;
              rows.resize(n_ids * tab.row_bytes);
              const int64_t* ids =
                  reinterpret_cast<const int64_t*>(req.payload.data());
              for (uint64_t i = 0; i < n_ids; i++) {
                int64_t r = ids[i];
                if (r < 0 || (uint64_t)r >= n_rows) {
                  std::memset(rows.data() + i * tab.row_bytes, 0,
                              tab.row_bytes);
                } else {
                  std::memcpy(rows.data() + i * tab.row_bytes,
                              tab.data.data() + (uint64_t)r * tab.row_bytes,
                              tab.row_bytes);
                }
              }
            }
          }
          if (!write_response(fd, status, rows.data(), rows.size()))
            goto done;
          break;
        }
        case kCheckpointNotify: {
          {
            std::lock_guard<std::mutex> lk(mu);
            notify_q.push_back(req.name);
          }
          cv.notify_all();
          seq_applied(t, req.seq);
          if (!write_response(fd, 0, nullptr, 0)) goto done;
          break;
        }
        default:
          goto done;
      }
    }
  done:
    ::close(fd);
  }

  void accept_loop() {
    while (true) {
      int fd = ::accept(listen_fd, nullptr, nullptr);
      if (fd < 0) {
        std::lock_guard<std::mutex> lk(mu);
        if (shutting_down) return;
        continue;
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        if (shutting_down) {
          ::close(fd);
          return;
        }
        conn_threads.emplace_back([this, fd] { handle_conn(fd); });
      }
    }
  }
};

struct RpcClient {
  int fd = -1;
  std::mutex mu;  // one in-flight request per connection
};

int64_t now_ms() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

}  // namespace

extern "C" {

// ---- server -------------------------------------------------------------

// returns handle or null; port 0 picks an ephemeral port
void* pt_rpc_server_create(int port, int n_trainers, int sync_mode) {
  auto* s = new RpcServer();
  s->n_trainers = n_trainers > 0 ? n_trainers : 1;
  s->sync_mode = sync_mode != 0;
  s->send_counts.assign(s->n_trainers, 0);
  s->fetch_counts.assign(s->n_trainers, 0);
  s->completed.assign(s->n_trainers, 0);
  s->last_active_ms.assign(s->n_trainers, 0);
  s->seq_windows.assign(s->n_trainers, RpcServer::SeqWindow());

  s->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (s->listen_fd < 0) {
    delete s;
    return nullptr;
  }
  int one = 1;
  setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(s->listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) <
          0 ||
      ::listen(s->listen_fd, 128) < 0) {
    ::close(s->listen_fd);
    delete s;
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(s->listen_fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  s->port = ntohs(addr.sin_port);
  s->accept_thread = std::thread([s] { s->accept_loop(); });
  return s;
}

int pt_rpc_server_port(void* h) { return static_cast<RpcServer*>(h)->port; }

// Wait until every non-complete trainer has passed its send barrier for the
// current step. Returns 0 = batch ready, 1 = timeout, 3 = all complete.
int pt_rpc_server_wait_sends(void* h, int timeout_ms) {
  auto* s = static_cast<RpcServer*>(h);
  std::unique_lock<std::mutex> lk(s->mu);
  auto ready = [s] {
    if (s->shutting_down || s->all_complete_locked()) return true;
    for (int t = 0; t < s->n_trainers; t++)
      if (!s->completed[t] && s->send_counts[t] < s->step + 1) return false;
    return true;
  };
  if (timeout_ms < 0) {
    s->cv.wait(lk, ready);
  } else if (!s->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                             ready)) {
    return 1;
  }
  if (s->all_complete_locked() || s->shutting_down) return 3;
  return 0;
}

// Publish params done: release GET waiters for this step.
void pt_rpc_server_begin_serve(void* h) {
  auto* s = static_cast<RpcServer*>(h);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->serving = true;
  }
  s->cv.notify_all();
}

// Wait for all fetch barriers, then advance to the next step.
// Returns 0 ok, 1 timeout, 3 all complete.
int pt_rpc_server_end_step(void* h, int timeout_ms) {
  auto* s = static_cast<RpcServer*>(h);
  std::unique_lock<std::mutex> lk(s->mu);
  auto ready = [s] {
    if (s->shutting_down || s->all_complete_locked()) return true;
    for (int t = 0; t < s->n_trainers; t++)
      if (!s->completed[t] && s->fetch_counts[t] < s->step + 1) return false;
    return true;
  };
  if (timeout_ms < 0) {
    s->cv.wait(lk, ready);
  } else if (!s->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                             ready)) {
    return 1;
  }
  s->step++;
  s->serving = false;
  if (s->all_complete_locked() || s->shutting_down) return 3;
  return 0;
}

// Take a received var (sync mode: name includes the @trainer_<i> suffix).
// Consumes the entry — a grad is merged into exactly one optimize round, so
// a trainer that stops sending (COMPLETE) cannot leak its last gradient
// into every later step. Returns 0 ok (*out malloc'd, caller pt_free),
// 1 not found.
int pt_rpc_server_get_recv(void* h, const char* name, uint8_t** out,
                           uint64_t* out_len) {
  auto* s = static_cast<RpcServer*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  auto it = s->recv_store.find(name);
  if (it == s->recv_store.end()) return 1;
  *out_len = it->second.size();
  *out = static_cast<uint8_t*>(std::malloc(it->second.size()));
  std::memcpy(*out, it->second.data(), it->second.size());
  s->recv_store.erase(it);
  return 0;
}

// Publish a served var (param).
void pt_rpc_server_put_param(void* h, const char* name, const uint8_t* data,
                             uint64_t len) {
  auto* s = static_cast<RpcServer*>(h);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->param_store[name].assign(data, data + len);
  }
  s->cv.notify_all();
}

// Async mode: pop one received (name, trainer_id, payload).
// Returns 0 ok, 1 timeout, 3 all complete and queue drained.
int pt_rpc_server_pop_send(void* h, char* name_out, int name_cap,
                           uint32_t* trainer_out, uint8_t** payload_out,
                           uint64_t* payload_len, int timeout_ms) {
  auto* s = static_cast<RpcServer*>(h);
  std::unique_lock<std::mutex> lk(s->mu);
  auto ready = [s] {
    return s->shutting_down || !s->async_q.empty() || s->all_complete_locked();
  };
  if (timeout_ms < 0) {
    s->cv.wait(lk, ready);
  } else if (!s->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                             ready)) {
    return 1;
  }
  if (s->async_q.empty()) return 3;
  Request req = std::move(s->async_q.front());
  s->async_q.pop_front();
  std::snprintf(name_out, name_cap, "%s", req.name.c_str());
  *trainer_out = req.trainer_id;
  *payload_len = req.payload.size();
  *payload_out = static_cast<uint8_t*>(std::malloc(req.payload.size()));
  std::memcpy(*payload_out, req.payload.data(), req.payload.size());
  return 0;
}

// Register/refresh a sparse table served by kPrefetch. data is the raw
// row-major value buffer; row_bytes the stride of one row. The O(table)
// copy happens OUTSIDE the server mutex (a giant table under the global
// lock would stall every request handler); only the swap is locked.
void pt_rpc_server_put_table(void* h, const char* name, const uint8_t* data,
                             uint64_t len, uint64_t row_bytes) {
  auto* s = static_cast<RpcServer*>(h);
  std::vector<uint8_t> staged(data, data + len);
  std::lock_guard<std::mutex> lk(s->mu);
  auto& t = s->table_store[name];
  t.data.swap(staged);
  t.row_bytes = row_bytes;
}

// Pop one checkpoint_notify directory. Returns 0 ok, 1 empty; if the name
// does not fit in cap (including the NUL), returns the negated required
// capacity WITHOUT popping, so the caller can retry with a larger buffer
// instead of silently saving the shard to a truncated path.
int pt_rpc_server_pop_notify(void* h, char* dir_out, int cap) {
  auto* s = static_cast<RpcServer*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  if (s->notify_q.empty()) return 1;
  const std::string& dir = s->notify_q.front();
  if (dir.size() + 1 > static_cast<size_t>(cap))
    return -static_cast<int>(dir.size() + 1);
  std::snprintf(dir_out, cap, "%s", dir.c_str());
  s->notify_q.pop_front();
  return 0;
}

// Worker liveness snapshot: out[t] = ms since trainer t's last request
// (-1 = never heard from). HeartBeatMonitor's data source.
void pt_rpc_server_worker_idle_ms(void* h, int64_t* out) {
  auto* s = static_cast<RpcServer*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  int64_t now = steady_ms();
  for (int t = 0; t < s->n_trainers; t++)
    out[t] = s->last_active_ms[t] ? now - s->last_active_ms[t] : -1;
}

int pt_rpc_server_n_complete(void* h) {
  auto* s = static_cast<RpcServer*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  int n = 0;
  for (auto c : s->completed) n += c ? 1 : 0;
  return n;
}

void pt_rpc_server_destroy(void* h) {
  auto* s = static_cast<RpcServer*>(h);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->shutting_down = true;
  }
  s->cv.notify_all();
  ::shutdown(s->listen_fd, SHUT_RDWR);
  ::close(s->listen_fd);
  if (s->accept_thread.joinable()) s->accept_thread.join();
  std::vector<std::thread> conns;
  {
    std::lock_guard<std::mutex> lk(s->mu);
    conns.swap(s->conn_threads);
  }
  for (auto& t : conns)
    if (t.joinable()) t.join();
  delete s;
}

// ---- client -------------------------------------------------------------

// Connect with retry until deadline (reference wait_port semantics,
// distribute_transpiler wait_port + rpc_client retry flags).
void* pt_rpc_connect(const char* host, int port, int timeout_ms) {
  int64_t deadline = now_ms() + (timeout_ms < 0 ? 60000 : timeout_ms);
  while (true) {
    int fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return nullptr;
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
      ::close(fd);
      return nullptr;
    }
    if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) == 0) {
      int one = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      auto* c = new RpcClient();
      c->fd = fd;
      return c;
    }
    ::close(fd);
    if (now_ms() >= deadline) return nullptr;
    std::this_thread::sleep_for(std::chrono::milliseconds(100));
  }
}

static int rpc_call(RpcClient* c, uint8_t opcode, uint32_t trainer_id,
                    uint64_t seq, const char* name, const uint8_t* payload,
                    uint64_t plen, uint8_t** out, uint64_t* out_len) {
  std::lock_guard<std::mutex> lk(c->mu);
  uint32_t name_len = name ? static_cast<uint32_t>(std::strlen(name)) : 0;
  if (!write_full(c->fd, &opcode, 1)) return -1;
  if (!write_full(c->fd, &trainer_id, 4)) return -1;
  if (!write_full(c->fd, &seq, 8)) return -1;
  if (!write_full(c->fd, &name_len, 4)) return -1;
  if (name_len && !write_full(c->fd, name, name_len)) return -1;
  if (!write_full(c->fd, &plen, 8)) return -1;
  if (plen && !write_full(c->fd, payload, plen)) return -1;
  uint8_t status;
  uint64_t rlen;
  if (!read_full(c->fd, &status, 1)) return -1;
  if (!read_full(c->fd, &rlen, 8)) return -1;
  std::vector<uint8_t> resp(rlen);
  if (rlen && !read_full(c->fd, resp.data(), rlen)) return -1;
  if (out && out_len) {
    *out_len = rlen;
    *out = static_cast<uint8_t*>(std::malloc(rlen ? rlen : 1));
    if (rlen) std::memcpy(*out, resp.data(), rlen);
  }
  return status;
}

// Mutating calls take the client-assigned per-operation seq (see the
// wire-protocol note); a retry of the same logical op MUST pass the same
// seq so the server can dedup it. Read-only calls pass no seq (0).

int pt_rpc_send_var(void* h, uint32_t trainer_id, uint64_t seq,
                    const char* name, const uint8_t* payload, uint64_t len) {
  return rpc_call(static_cast<RpcClient*>(h), kSendVar, trainer_id, seq, name,
                  payload, len, nullptr, nullptr);
}

// returns 0 ok (*out malloc'd), 1 not found, 2 shutdown, -1 io error
int pt_rpc_get_var(void* h, uint32_t trainer_id, const char* name,
                   uint8_t** out, uint64_t* out_len) {
  return rpc_call(static_cast<RpcClient*>(h), kGetVar, trainer_id, 0, name,
                  nullptr, 0, out, out_len);
}

int pt_rpc_send_barrier(void* h, uint32_t trainer_id, uint64_t seq) {
  return rpc_call(static_cast<RpcClient*>(h), kSendBarrier, trainer_id, seq,
                  nullptr, nullptr, 0, nullptr, nullptr);
}

int pt_rpc_fetch_barrier(void* h, uint32_t trainer_id, uint64_t seq) {
  return rpc_call(static_cast<RpcClient*>(h), kFetchBarrier, trainer_id, seq,
                  nullptr, nullptr, 0, nullptr, nullptr);
}

int pt_rpc_complete(void* h, uint32_t trainer_id, uint64_t seq) {
  return rpc_call(static_cast<RpcClient*>(h), kComplete, trainer_id, seq,
                  nullptr, nullptr, 0, nullptr, nullptr);
}

// Fetch table rows: ids = raw int64 array, *out = raw row bytes.
int pt_rpc_prefetch(void* h, uint32_t trainer_id, const char* table,
                    const uint8_t* ids, uint64_t ids_len, uint8_t** out,
                    uint64_t* out_len) {
  return rpc_call(static_cast<RpcClient*>(h), kPrefetch, trainer_id, 0, table,
                  ids, ids_len, out, out_len);
}

int pt_rpc_checkpoint_notify(void* h, uint32_t trainer_id, uint64_t seq,
                             const char* dir) {
  return rpc_call(static_cast<RpcClient*>(h), kCheckpointNotify, trainer_id,
                  seq, dir, nullptr, 0, nullptr, nullptr);
}

// Honor FLAGS rpc_deadline: bound every send/recv on this connection.
void pt_rpc_set_deadline(void* h, int deadline_ms) {
  auto* c = static_cast<RpcClient*>(h);
  timeval tv{};
  tv.tv_sec = deadline_ms / 1000;
  tv.tv_usec = (deadline_ms % 1000) * 1000;
  setsockopt(c->fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  setsockopt(c->fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
}

void pt_rpc_close(void* h) {
  auto* c = static_cast<RpcClient*>(h);
  ::close(c->fd);
  delete c;
}

}  // extern "C"
