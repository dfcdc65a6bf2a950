// Native windowed-trajectory batch loader (the port's copy of
// beso_tpu/data/native/slicer.cc; the same code, so both packages' batches
// agree for a (seed, batch id)).
//
// Host-side counterpart of data/slicer.py for datasets too large to live in
// device memory. The reference relies on torch's DataLoader (C++ core, 4
// worker processes, pinned staging — kitchen_workspace_manager.py:149-163);
// this is a thread-pooled window gather over caller-owned (typically
// memory-mapped .npy) float32 trajectory buffers, with a double-buffered
// background prefetch ring so the gather of batch k+1 overlaps the
// host->device copy and device compute of batch k.
//
// Semantics mirror SlicedDataset exactly:
//  * slice table = all (traj, start) with start + window <= length
//    (trajectory_loader.py:129-138),
//  * future-conditional goal start uniform in [end + min_future_sep, T - G)
//    with tail/seq-end variants and a zero-fill fallback when the range is
//    empty (trajectory_loader.py:169-186).
//
// Determinism: batches are a pure function of (seed, batch_counter) via
// splitmix64 — no global RNG, no worker-order nondeterminism (the torch
// loader's np.random-in-worker draw is famously irreproducible,
// trajectory_loader.py:180, SURVEY 5.2).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC slicer.cc -o libslicer.so -lpthread
// (driven by beso_tpu_torch/data/native/__init__.py, into build/native/).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// splitmix64: counter-based, statistically solid for index generation
inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

struct Loader {
  const float* obs;   // [n_traj, t_max, obs_dim]
  const float* act;   // [n_traj, t_max, act_dim]
  std::vector<int32_t> lengths;
  int n_traj, t_max, obs_dim, act_dim;
  int window, future_seq_len, min_future_sep;
  bool only_tail, only_seq_end, future_conditional;
  int n_threads;

  std::vector<int32_t> slices;  // flattened (traj, start) pairs
  std::atomic<uint64_t> batch_counter{0};

  // prefetch ring
  struct Buffer {
    std::vector<float> obs, act, goal;
    uint64_t ticket = 0;
    bool ready = false;
  };
  std::vector<Buffer> ring;
  int prefetch_batch = 0;
  uint64_t prefetch_seed = 0;
  uint64_t produce_ticket = 0, consume_ticket = 0;
  std::thread producer;
  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  bool stopping = false;

  ~Loader() { stop_prefetch(); }

  void build_slices() {
    for (int i = 0; i < n_traj; ++i) {
      for (int s = 0; s + window <= lengths[i]; ++s) {
        slices.push_back(i);
        slices.push_back(s);
      }
    }
  }

  size_t n_slices() const { return slices.size() / 2; }

  // fill one item (row b) of a batch
  void fill_item(uint64_t seed, uint64_t batch_id, int b, float* out_obs,
                 float* out_act, float* out_goal) const {
    uint64_t base = splitmix64(seed ^ splitmix64(batch_id * 0x51ull + 17));
    uint64_t r0 = splitmix64(base + 2 * (uint64_t)b);
    uint64_t r1 = splitmix64(base + 2 * (uint64_t)b + 1);
    size_t idx = (size_t)(r0 % n_slices());
    int traj = slices[2 * idx];
    int start = slices[2 * idx + 1];

    const size_t o_row = (size_t)obs_dim;
    const size_t a_row = (size_t)act_dim;
    const float* o_src = obs + ((size_t)traj * t_max + start) * o_row;
    const float* a_src = act + ((size_t)traj * t_max + start) * a_row;
    std::memcpy(out_obs + (size_t)b * window * o_row, o_src,
                sizeof(float) * window * o_row);
    std::memcpy(out_act + (size_t)b * window * a_row, a_src,
                sizeof(float) * window * a_row);

    if (!future_conditional) return;
    int G = future_seq_len;
    int T = lengths[traj];
    int end = start + window;
    int lo = end + min_future_sep;
    int hi = T - G;  // exclusive upper start
    float* g_dst = out_goal + (size_t)b * G * o_row;
    if (lo >= hi) {  // zero-fill fallback (trajectory_loader.py:183-186)
      std::memset(g_dst, 0, sizeof(float) * G * o_row);
      return;
    }
    int g_start;
    if (only_tail) {
      g_start = T - G;
    } else if (only_seq_end) {
      g_start = end;
    } else {
      int span = hi - lo;
      g_start = lo + (int)(r1 % (uint64_t)span);
    }
    // clip to valid rows (mirrors the jnp.clip in slicer.py)
    if (g_start + G > t_max) g_start = t_max - G;
    const float* g_src = obs + ((size_t)traj * t_max + g_start) * o_row;
    std::memcpy(g_dst, g_src, sizeof(float) * G * o_row);
  }

  void fill_batch(uint64_t seed, uint64_t batch_id, int batch, float* out_obs,
                  float* out_act, float* out_goal) const {
    int nt = n_threads > 0 ? n_threads : 1;
    if (nt == 1 || batch < 2 * nt) {
      for (int b = 0; b < batch; ++b)
        fill_item(seed, batch_id, b, out_obs, out_act, out_goal);
      return;
    }
    std::vector<std::thread> ths;
    std::atomic<int> next{0};
    for (int t = 0; t < nt; ++t) {
      ths.emplace_back([&]() {
        int b;
        while ((b = next.fetch_add(1)) < batch)
          fill_item(seed, batch_id, b, out_obs, out_act, out_goal);
      });
    }
    for (auto& th : ths) th.join();
  }

  // ---- prefetch ring -----------------------------------------------------
  void start_prefetch(uint64_t seed, int batch, int n_buffers) {
    stop_prefetch();
    prefetch_seed = seed;
    prefetch_batch = batch;
    ring.assign((size_t)n_buffers, Buffer{});
    for (auto& buf : ring) {
      buf.obs.resize((size_t)batch * window * obs_dim);
      buf.act.resize((size_t)batch * window * act_dim);
      buf.goal.resize((size_t)batch * future_seq_len * obs_dim);
    }
    produce_ticket = consume_ticket = 0;
    stopping = false;
    producer = std::thread([this]() {
      for (;;) {
        std::unique_lock<std::mutex> lk(mu);
        cv_produce.wait(lk, [this]() {
          return stopping ||
                 produce_ticket < consume_ticket + ring.size();
        });
        if (stopping) return;
        uint64_t ticket = produce_ticket;
        Buffer& buf = ring[ticket % ring.size()];
        lk.unlock();
        fill_batch(prefetch_seed, ticket, prefetch_batch, buf.obs.data(),
                   buf.act.data(), buf.goal.data());
        lk.lock();
        buf.ticket = ticket;
        buf.ready = true;
        ++produce_ticket;
        cv_consume.notify_all();
      }
    });
  }

  int wait_next(float** o, float** a, float** g) {
    std::unique_lock<std::mutex> lk(mu);
    uint64_t want = consume_ticket;
    cv_consume.wait(lk, [this, want]() {
      Buffer& buf = ring[want % ring.size()];
      return buf.ready && buf.ticket == want;
    });
    Buffer& buf = ring[want % ring.size()];
    *o = buf.obs.data();
    *a = buf.act.data();
    *g = buf.goal.data();
    return (int)(want % ring.size());
  }

  void release(int) {
    std::unique_lock<std::mutex> lk(mu);
    ring[consume_ticket % ring.size()].ready = false;
    ++consume_ticket;
    cv_produce.notify_all();
  }

  void stop_prefetch() {
    if (producer.joinable()) {
      {
        std::unique_lock<std::mutex> lk(mu);
        stopping = true;
      }
      cv_produce.notify_all();
      producer.join();
    }
  }
};

}  // namespace

extern "C" {

void* loader_create(const float* obs, const float* act,
                    const int32_t* lengths, int n_traj, int t_max,
                    int obs_dim, int act_dim, int window,
                    int future_conditional, int future_seq_len,
                    int min_future_sep, int only_tail, int only_seq_end,
                    int n_threads) {
  auto* L = new Loader();
  L->obs = obs;
  L->act = act;
  L->lengths.assign(lengths, lengths + n_traj);
  L->n_traj = n_traj;
  L->t_max = t_max;
  L->obs_dim = obs_dim;
  L->act_dim = act_dim;
  L->window = window;
  L->future_conditional = future_conditional != 0;
  L->future_seq_len = future_seq_len;
  L->min_future_sep = min_future_sep;
  L->only_tail = only_tail != 0;
  L->only_seq_end = only_seq_end != 0;
  L->n_threads = n_threads;
  L->build_slices();
  return L;
}

int64_t loader_num_slices(void* p) {
  return (int64_t) static_cast<Loader*>(p)->n_slices();
}

void loader_slices(void* p, int32_t* out) {
  auto* L = static_cast<Loader*>(p);
  std::memcpy(out, L->slices.data(), L->slices.size() * sizeof(int32_t));
}

void loader_sample_batch(void* p, uint64_t seed, uint64_t batch_id, int batch,
                         float* out_obs, float* out_act, float* out_goal) {
  static_cast<Loader*>(p)->fill_batch(seed, batch_id, batch, out_obs, out_act,
                                      out_goal);
}

void loader_start_prefetch(void* p, uint64_t seed, int batch, int n_buffers) {
  static_cast<Loader*>(p)->start_prefetch(seed, batch, n_buffers);
}

int loader_wait_next(void* p, float** o, float** a, float** g) {
  return static_cast<Loader*>(p)->wait_next(o, a, g);
}

void loader_release(void* p, int buf_id) {
  static_cast<Loader*>(p)->release(buf_id);
}

void loader_destroy(void* p) { delete static_cast<Loader*>(p); }

}  // extern "C"
