// Asynchronous metrics recorder of the vmc_pde_torch runtime.
//
// The step loop must never wait on diagnostics IO: each step's records
// (observables, solver diagnostics, the latent's parameters) are pushed
// into a bounded in-memory queue and written to a compact binary log by a
// background thread. The Python side (vmc_pde_torch/utils/recorder.py)
// reaches this through ctypes and converts the log to the infos dict of
// utils/infos.py. The format is the JAX package's recorder's, so either
// package reads a log written by the other.
//
// Binary format (little-endian):
//   header : magic "VPDR1\0" (6 bytes) + u16 version
//   record : u8 kind
//     kind 0 (tag def) : u32 tag_id, u32 name_len, name bytes
//     kind 1 (data)    : u32 tag_id, u64 step, f64 wall_time,
//                        u64 n_values, f64 values[n]
//
// Build (utils/recorder.py does it on first use):
//   g++ -O2 -std=c++17 -shared -fPIC -o librecorder.so recorder.cpp -lpthread

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Recorder {
  FILE* file = nullptr;
  std::thread writer;
  std::mutex mu;
  std::condition_variable cv_push;   // signalled when data arrives / closing
  std::condition_variable cv_space;  // signalled when the queue drains
  std::deque<std::vector<uint8_t>> queue;
  size_t queued_bytes = 0;
  size_t max_bytes = 0;
  bool closing = false;
  uint32_t next_tag = 0;

  explicit Recorder(FILE* f, size_t cap) : file(f), max_bytes(cap) {
    writer = std::thread([this] { this->drain(); });
  }

  void drain() {
    for (;;) {
      std::vector<uint8_t> rec;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_push.wait(lk, [this] { return closing || !queue.empty(); });
        if (queue.empty()) {
          if (closing) return;
          continue;
        }
        rec = std::move(queue.front());
        queue.pop_front();
        queued_bytes -= rec.size();
        cv_space.notify_all();
      }
      fwrite(rec.data(), 1, rec.size(), file);
    }
  }

  // Blocks briefly when the queue is full (bounded memory, no data loss).
  void push(std::vector<uint8_t>&& rec) {
    std::unique_lock<std::mutex> lk(mu);
    cv_space.wait(lk, [this, &rec] {
      return closing || queued_bytes + rec.size() <= max_bytes ||
             queue.empty();
    });
    if (closing) return;
    queued_bytes += rec.size();
    queue.push_back(std::move(rec));
    cv_push.notify_one();
  }

  void close() {
    {
      std::unique_lock<std::mutex> lk(mu);
      closing = true;
      cv_push.notify_all();
      cv_space.notify_all();
    }
    if (writer.joinable()) writer.join();
    // drain whatever remains synchronously
    for (auto& rec : queue) fwrite(rec.data(), 1, rec.size(), file);
    queue.clear();
    fflush(file);
    fclose(file);
  }
};

template <typename T>
void append(std::vector<uint8_t>& buf, const T& v) {
  const auto* p = reinterpret_cast<const uint8_t*>(&v);
  buf.insert(buf.end(), p, p + sizeof(T));
}

double wall_time() {
  struct timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return static_cast<double>(ts.tv_sec) + 1e-9 * ts.tv_nsec;
}

}  // namespace

extern "C" {

void* rec_open(const char* path, size_t ring_bytes) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  const char magic[6] = {'V', 'P', 'D', 'R', '1', '\0'};
  fwrite(magic, 1, 6, f);
  uint16_t version = 1;
  fwrite(&version, sizeof(version), 1, f);
  return new Recorder(f, ring_bytes ? ring_bytes : (64u << 20));
}

int rec_register(void* h, const char* name) {
  auto* r = static_cast<Recorder*>(h);
  uint32_t tag;
  {
    std::unique_lock<std::mutex> lk(r->mu);
    tag = r->next_tag++;
  }
  std::vector<uint8_t> buf;
  append<uint8_t>(buf, 0);
  append<uint32_t>(buf, tag);
  uint32_t len = static_cast<uint32_t>(strlen(name));
  append<uint32_t>(buf, len);
  buf.insert(buf.end(), name, name + len);
  r->push(std::move(buf));
  return static_cast<int>(tag);
}

int rec_write(void* h, int tag, uint64_t step, const double* data,
              uint64_t n) {
  auto* r = static_cast<Recorder*>(h);
  std::vector<uint8_t> buf;
  buf.reserve(1 + 4 + 8 + 8 + 8 + n * 8);
  append<uint8_t>(buf, 1);
  append<uint32_t>(buf, static_cast<uint32_t>(tag));
  append<uint64_t>(buf, step);
  append<double>(buf, wall_time());
  append<uint64_t>(buf, n);
  const auto* p = reinterpret_cast<const uint8_t*>(data);
  buf.insert(buf.end(), p, p + n * 8);
  r->push(std::move(buf));
  return 0;
}

void rec_close(void* h) {
  auto* r = static_cast<Recorder*>(h);
  r->close();
  delete r;
}

}  // extern "C"
