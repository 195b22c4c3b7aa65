// kfcoord: DCN coordination / membership service for the TPU-native
// framework's control plane.
//
// This is the native equivalent of the capabilities the reference
// delegates to KungFu's Go+C++ peer runtime and config server
// (ref: scripts/tf_cnn_benchmarks/README.md "Running KungFu";
// kungfu-run's membership wiring, run_barrier at
// tf_cnn_benchmarks.py:58-60, cluster-size/rank queries at
// benchmark_cnn.py:1408-1410, and the elastic-membership config service
// described in SURVEY 2.9/5.3). The XLA SPMD runtime owns the data plane
// (ICI collectives); this service owns the host-side control plane over
// DCN: membership + rank assignment, named barriers, a key-value
// bootstrap store (for address exchange / broadcast-at-init digests),
// and generation-numbered elastic resize.
//
// Design: one coordinator process (or in-process server thread), N
// clients over TCP. Text protocol, newline-delimited, length-safe:
//   JOIN <name>            -> OK <rank> <size> <generation>
//   SIZE                   -> OK <size> <generation>
//   BARRIER <name> <count> -> OK            (blocks until <count> enter)
//   PUT <key> <hex>        -> OK
//   GET <key>              -> OK <hex>      (blocks until the key exists)
//   RESIZE <new_size>      -> OK <generation>  (bumps generation)
//   GEN                    -> OK <generation>
//   LEAVE                  -> OK
// All state is in-memory; the coordinator is restartable because clients
// re-JOIN on reconnect (checkpoint-based recovery is the framework's job,
// SURVEY 5.3/5.4).
//
// Exposed as a C API for ctypes (pybind11 is not available in this
// environment).

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <set>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Server state
// ---------------------------------------------------------------------------

struct ServerState {
  std::mutex mu;
  std::condition_variable cv;
  int next_rank = 0;
  long generation = 0;
  std::map<std::string, int> members;           // name -> rank
  std::map<std::string, int> barrier_counts;    // barrier name -> waiters in
  std::map<std::string, long> barrier_epoch;    // barrier name -> release gen
  std::map<std::string, std::string> kv;
  std::atomic<bool> stopping{false};
  int listen_fd = -1;
  int port = 0;
  int active_conns = 0;  // detached handler threads still running
  std::set<int> conn_fds;  // open connections, for shutdown-on-stop
  std::thread accept_thread;
};

bool send_all(int fd, const std::string& s) {
  size_t off = 0;
  while (off < s.size()) {
    ssize_t n = ::send(fd, s.data() + off, s.size() - off, MSG_NOSIGNAL);
    if (n <= 0) return false;
    off += static_cast<size_t>(n);
  }
  return true;
}

// Reads one newline-terminated line (without the newline). Returns false on
// EOF/error.
bool recv_line(int fd, std::string* line) {
  line->clear();
  char c;
  while (true) {
    ssize_t n = ::recv(fd, &c, 1, 0);
    if (n <= 0) return false;
    if (c == '\n') return true;
    line->push_back(c);
    if (line->size() > (1u << 22)) return false;  // 4MB line cap
  }
}

void handle_connection(ServerState* st, int fd) {
  std::string line;
  std::string joined_name;
  while (!st->stopping.load() && recv_line(fd, &line)) {
    std::istringstream in(line);
    std::string cmd;
    in >> cmd;
    std::ostringstream out;
    if (cmd == "JOIN") {
      std::string name;
      in >> name;
      std::unique_lock<std::mutex> lk(st->mu);
      auto it = st->members.find(name);
      int rank;
      if (it != st->members.end()) {
        rank = it->second;  // idempotent re-join (reconnect)
      } else {
        rank = st->next_rank++;
        st->members[name] = rank;
        st->generation++;
        st->cv.notify_all();
      }
      joined_name = name;
      out << "OK " << rank << " " << st->members.size() << " "
          << st->generation << "\n";
    } else if (cmd == "SIZE") {
      std::unique_lock<std::mutex> lk(st->mu);
      out << "OK " << st->members.size() << " " << st->generation << "\n";
    } else if (cmd == "GEN") {
      std::unique_lock<std::mutex> lk(st->mu);
      out << "OK " << st->generation << "\n";
    } else if (cmd == "BARRIER") {
      std::string name;
      long count = 0;
      in >> name >> count;
      if (name.empty() || count < 1) {
        // A zero/garbled count would make ++counts >= count instantly
        // true and release legitimately parked waiters early.
        if (!send_all(fd, "ERR bad-barrier-count\n")) break;
        continue;
      }
      std::unique_lock<std::mutex> lk(st->mu);
      long my_epoch = st->barrier_epoch[name];
      if (++st->barrier_counts[name] >= count) {
        st->barrier_counts[name] = 0;
        st->barrier_epoch[name] = my_epoch + 1;
        st->cv.notify_all();
      } else {
        st->cv.wait(lk, [&] {
          return st->stopping.load() || st->barrier_epoch[name] != my_epoch;
        });
      }
      out << (st->stopping.load() ? "ERR stopping\n" : "OK\n");
    } else if (cmd == "PUT") {
      std::string key, hex;
      in >> key >> hex;
      std::unique_lock<std::mutex> lk(st->mu);
      st->kv[key] = hex;
      st->cv.notify_all();
      out << "OK\n";
    } else if (cmd == "GET") {
      std::string key;
      in >> key;
      std::unique_lock<std::mutex> lk(st->mu);
      st->cv.wait(lk, [&] {
        return st->stopping.load() || st->kv.count(key) > 0;
      });
      if (st->stopping.load() && !st->kv.count(key)) {
        out << "ERR stopping\n";
      } else {
        out << "OK " << st->kv[key] << "\n";
      }
    } else if (cmd == "TRYGET") {
      // Non-blocking probe: MISS when absent (poll paths must not park).
      std::string key;
      in >> key;
      std::unique_lock<std::mutex> lk(st->mu);
      if (st->kv.count(key) > 0) {
        out << "OK " << st->kv[key] << "\n";
      } else {
        out << "MISS\n";
      }
    } else if (cmd == "RESIZE") {
      long new_size = 0;
      in >> new_size;
      std::unique_lock<std::mutex> lk(st->mu);
      st->generation++;
      st->kv["__target_size__"] = std::to_string(new_size);
      st->cv.notify_all();
      out << "OK " << st->generation << "\n";
    } else if (cmd == "LEAVE") {
      std::unique_lock<std::mutex> lk(st->mu);
      if (!joined_name.empty()) {
        st->members.erase(joined_name);
        st->generation++;
        st->cv.notify_all();
      }
      out << "OK\n";
      send_all(fd, out.str());
      break;
    } else {
      out << "ERR unknown-command\n";
    }
    if (!send_all(fd, out.str())) break;
  }
  {
    // After this block the handler must not touch *st: once
    // active_conns hits zero, server stop may free it.
    std::lock_guard<std::mutex> lk(st->mu);
    st->conn_fds.erase(fd);
    st->active_conns--;
    st->cv.notify_all();
  }
  ::close(fd);
}

void accept_loop(ServerState* st) {
  while (!st->stopping.load()) {
    sockaddr_in addr{};
    socklen_t len = sizeof(addr);
    int fd = ::accept(st->listen_fd, reinterpret_cast<sockaddr*>(&addr),
                      &len);
    if (fd < 0) {
      if (st->stopping.load()) break;
      continue;
    }
    int one = 1;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    {
      std::lock_guard<std::mutex> lk(st->mu);
      st->conn_fds.insert(fd);
      st->active_conns++;
    }
    // Detached: handlers are reaped via the active_conns count, not
    // join, so a long-lived coordinator serving many short-lived
    // clients does not accumulate joinable thread carcasses.
    std::thread(handle_connection, st, fd).detach();
  }
}

// ---------------------------------------------------------------------------
// Client state
// ---------------------------------------------------------------------------

struct ClientState {
  int fd = -1;
  std::mutex mu;  // serialize request/response pairs
};

bool client_rpc(ClientState* c, const std::string& req, std::string* resp) {
  std::lock_guard<std::mutex> lk(c->mu);
  if (c->fd < 0) return false;
  if (!send_all(c->fd, req)) return false;
  return recv_line(c->fd, resp);
}

}  // namespace

extern "C" {

// -- server -----------------------------------------------------------------

// Starts the coordinator on `port` (0 = ephemeral). Returns an opaque
// handle, or null on failure. The actual port is written to *out_port.
void* kfcoord_server_start(int port, int* out_port) {
  auto* st = new ServerState();
  st->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (st->listen_fd < 0) {
    delete st;
    return nullptr;
  }
  int one = 1;
  ::setsockopt(st->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(st->listen_fd, reinterpret_cast<sockaddr*>(&addr),
             sizeof(addr)) != 0 ||
      ::listen(st->listen_fd, 128) != 0) {
    ::close(st->listen_fd);
    delete st;
    return nullptr;
  }
  socklen_t len = sizeof(addr);
  ::getsockname(st->listen_fd, reinterpret_cast<sockaddr*>(&addr), &len);
  st->port = ntohs(addr.sin_port);
  if (out_port != nullptr) *out_port = st->port;
  st->accept_thread = std::thread(accept_loop, st);
  return st;
}

void kfcoord_server_stop(void* handle) {
  auto* st = static_cast<ServerState*>(handle);
  if (st == nullptr) return;
  st->stopping.store(true);
  {
    // Wake cv-waiters AND connection threads parked in recv(): shutdown
    // on each open fd makes their recv return 0 so they observe
    // `stopping` and exit -- without this, stop() deadlocks joining a
    // thread that is blocked reading from a still-connected client.
    std::lock_guard<std::mutex> lk(st->mu);
    st->cv.notify_all();
    for (int fd : st->conn_fds) ::shutdown(fd, SHUT_RDWR);
  }
  ::shutdown(st->listen_fd, SHUT_RDWR);
  ::close(st->listen_fd);
  if (st->accept_thread.joinable()) st->accept_thread.join();
  {
    // Wait for detached handlers to drain before freeing the state.
    std::unique_lock<std::mutex> lk(st->mu);
    st->cv.wait(lk, [&] { return st->active_conns == 0; });
  }
  delete st;
}

// -- client -----------------------------------------------------------------

void* kfcoord_connect(const char* host, int port, int timeout_ms) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    ::close(fd);
    return nullptr;
  }
  // Retry within the timeout window: the coordinator may start after its
  // workers under a parallel launcher.
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  while (::connect(fd, reinterpret_cast<sockaddr*>(&addr),
                   sizeof(addr)) != 0) {
    ::close(fd);
    if (std::chrono::steady_clock::now() >= deadline) return nullptr;
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
    fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return nullptr;
  }
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  auto* c = new ClientState();
  c->fd = fd;
  return c;
}

void kfcoord_close(void* client) {
  auto* c = static_cast<ClientState*>(client);
  if (c == nullptr) return;
  if (c->fd >= 0) ::close(c->fd);
  delete c;
}

// Returns rank >= 0, or -1 on error. Writes size/generation out-params.
int kfcoord_join(void* client, const char* name, int* out_size,
                 long* out_generation) {
  auto* c = static_cast<ClientState*>(client);
  std::string resp;
  if (!client_rpc(c, std::string("JOIN ") + name + "\n", &resp)) return -1;
  int rank = -1, size = 0;
  long gen = 0;
  if (std::sscanf(resp.c_str(), "OK %d %d %ld", &rank, &size, &gen) != 3)
    return -1;
  if (out_size != nullptr) *out_size = size;
  if (out_generation != nullptr) *out_generation = gen;
  return rank;
}

int kfcoord_cluster_size(void* client) {
  auto* c = static_cast<ClientState*>(client);
  std::string resp;
  if (!client_rpc(c, "SIZE\n", &resp)) return -1;
  int size = 0;
  long gen = 0;
  if (std::sscanf(resp.c_str(), "OK %d %ld", &size, &gen) != 2) return -1;
  return size;
}

long kfcoord_generation(void* client) {
  auto* c = static_cast<ClientState*>(client);
  std::string resp;
  if (!client_rpc(c, "GEN\n", &resp)) return -1;
  long gen = 0;
  if (std::sscanf(resp.c_str(), "OK %ld", &gen) != 1) return -1;
  return gen;
}

// Blocks until `count` participants enter the named barrier. Returns 0 on
// success, -1 on error.
int kfcoord_barrier(void* client, const char* name, int count) {
  auto* c = static_cast<ClientState*>(client);
  std::ostringstream req;
  req << "BARRIER " << name << " " << count << "\n";
  std::string resp;
  if (!client_rpc(c, req.str(), &resp)) return -1;
  return resp.rfind("OK", 0) == 0 ? 0 : -1;
}

int kfcoord_kv_put(void* client, const char* key, const char* hex_value) {
  auto* c = static_cast<ClientState*>(client);
  std::string resp;
  if (!client_rpc(c, std::string("PUT ") + key + " " + hex_value + "\n",
                  &resp))
    return -1;
  return resp.rfind("OK", 0) == 0 ? 0 : -1;
}

// Blocks until the key exists. Copies the hex value into `buf` (size
// `buf_len`, NUL-terminated). Returns value length, or -1 on error, or -2
// if the buffer is too small.
int kfcoord_kv_get(void* client, const char* key, char* buf, int buf_len) {
  auto* c = static_cast<ClientState*>(client);
  std::string resp;
  if (!client_rpc(c, std::string("GET ") + key + "\n", &resp)) return -1;
  if (resp.rfind("OK ", 0) != 0) return -1;
  std::string value = resp.substr(3);
  if (static_cast<int>(value.size()) + 1 > buf_len) return -2;
  std::memcpy(buf, value.c_str(), value.size() + 1);
  return static_cast<int>(value.size());
}

// Non-blocking probe. Returns value length (>= 0) on hit, -3 on miss,
// -1 on error, -2 if the buffer is too small.
int kfcoord_kv_tryget(void* client, const char* key, char* buf,
                      int buf_len) {
  auto* c = static_cast<ClientState*>(client);
  std::string resp;
  if (!client_rpc(c, std::string("TRYGET ") + key + "\n", &resp)) return -1;
  if (resp.rfind("MISS", 0) == 0) return -3;
  if (resp.rfind("OK ", 0) != 0) return -1;
  std::string value = resp.substr(3);
  if (static_cast<int>(value.size()) + 1 > buf_len) return -2;
  std::memcpy(buf, value.c_str(), value.size() + 1);
  return static_cast<int>(value.size());
}

// Elastic resize request: bumps the generation and records the target
// size under "__target_size__". Returns the new generation, or -1.
long kfcoord_resize(void* client, int new_size) {
  auto* c = static_cast<ClientState*>(client);
  std::ostringstream req;
  req << "RESIZE " << new_size << "\n";
  std::string resp;
  if (!client_rpc(c, req.str(), &resp)) return -1;
  long gen = 0;
  if (std::sscanf(resp.c_str(), "OK %ld", &gen) != 1) return -1;
  return gen;
}

int kfcoord_leave(void* client) {
  auto* c = static_cast<ClientState*>(client);
  std::string resp;
  if (!client_rpc(c, "LEAVE\n", &resp)) return -1;
  return resp.rfind("OK", 0) == 0 ? 0 : -1;
}

}  // extern "C"
