// Persistent level-batched worker pool shared by the native commit
// pipeline (mpt.cpp / mpt_inc.cpp / keccak.cpp).
//
// The reference fans each trie hash out over 16 goroutines
// (trie/hasher.go:124-139) against a warm runtime scheduler; the naive
// C++ translation — spawn std::threads per level segment — pays a
// thread create+join (~50-100us) per segment, which at ~20 height
// levels per commit costs more than hashing the small levels. This
// pool keeps min-configured workers parked on a condition variable and
// wakes them per batch, so the per-level dispatch cost drops to a
// condvar signal and small levels become worth threading at all.
//
// Design notes:
//   - leaked singleton (`new`, never deleted): the .so can be used from
//     Python atexit/GC paths, so the pool must never run destructors
//     that join threads during process teardown
//   - the CALLER participates as worker 0, so `threads=N` means N lanes
//     of execution, matching the plain std::thread code it replaces
//   - one batch at a time (runs serialize on an internal mutex); call
//     sites are leaf-level loops, never nested
//   - completion is counted only by workers that actually ran the
//     function for the current generation, so a pool larger than one
//     batch's thread count can never signal completion early
//
// Each .so that includes this header gets its own pool instance (the
// namespace is anonymous-linkage via `inline`), which keeps the three
// libraries independently loadable.

#pragma once

#include <algorithm>
#include <condition_variable>
#include <cstdlib>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace mptp {

// Default fan-out: CORETH_TPU_CPU_THREADS overrides; otherwise
// min(16, hardware_concurrency) — the reference's 16-way cap.
inline int default_threads() {
  const char* e = std::getenv("CORETH_TPU_CPU_THREADS");
  if (e && *e) {
    int v = std::atoi(e);
    if (v > 0) return v;
  }
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 1;
  return (int)std::min(16u, hw);
}

class WorkerPool {
 public:
  static WorkerPool& instance() {
    static WorkerPool* p = new WorkerPool();  // leaked by design (see top)
    return *p;
  }

  // Run fn(t, nt) for t in [0, threads). The calling thread runs t=0;
  // parked workers run the rest. Blocks until every lane returns.
  // The requested count is honored as-is (no hardware_concurrency
  // clamp): the default policy already clamps (default_threads), and an
  // explicit oversubscribed request must still exercise the pool — that
  // is how the bit-exactness tests drive the synchronization on small
  // containers.
  void parallel(int threads, const std::function<void(int, int)>& fn) {
    int nt = std::min(threads, 64);  // sanity ceiling, not a policy
    if (nt <= 1) {
      fn(0, 1);
      return;
    }
    std::lock_guard<std::mutex> run_lock(run_m_);  // one batch at a time
    ensure_workers(nt - 1);
    {
      std::lock_guard<std::mutex> lk(m_);
      fn_ = &fn;
      nt_ = nt;
      done_ = 0;
      ++gen_;
    }
    cv_work_.notify_all();
    fn(0, nt);
    std::unique_lock<std::mutex> lk(m_);
    cv_done_.wait(lk, [&] { return done_ == nt_ - 1; });
    fn_ = nullptr;
  }

 private:
  WorkerPool() = default;

  void ensure_workers(int n) {
    if ((int)workers_.size() >= n) return;
    std::lock_guard<std::mutex> lk(m_);
    while ((int)workers_.size() < n) {
      int wid = (int)workers_.size();
      workers_.emplace_back([this, wid] { worker_loop(wid); });
    }
  }

  void worker_loop(int wid) {
    uint64_t seen = 0;
    for (;;) {
      const std::function<void(int, int)>* fn = nullptr;
      int nt = 0;
      {
        std::unique_lock<std::mutex> lk(m_);
        cv_work_.wait(lk, [&] { return gen_ != seen; });
        seen = gen_;
        fn = fn_;
        nt = nt_;
      }
      // workers beyond this batch's fan-out neither run nor count —
      // they just park again (completion would otherwise signal early)
      if (fn == nullptr || wid + 1 >= nt) continue;
      (*fn)(wid + 1, nt);
      {
        std::lock_guard<std::mutex> lk(m_);
        ++done_;
        if (done_ == nt_ - 1) cv_done_.notify_all();
      }
    }
  }

  std::mutex run_m_;  // serializes parallel() callers
  std::mutex m_;
  std::condition_variable cv_work_;
  std::condition_variable cv_done_;
  std::vector<std::thread> workers_;
  const std::function<void(int, int)>* fn_ = nullptr;
  int nt_ = 0;
  int done_ = 0;
  uint64_t gen_ = 0;
};

// Convenience wrapper: pooled fan-out with the caller as lane 0.
inline void parallel(int threads, const std::function<void(int, int)>& fn) {
  WorkerPool::instance().parallel(threads, fn);
}

}  // namespace mptp
