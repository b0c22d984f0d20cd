// Fast discrete-event baseline-scheduler engine (L1, host C++).
//
// The port's own copy of the JAX package's native/fast_oracle.cpp (the
// code is the same; only this header differs): the C++ counterpart of
// sim/oracle.py + sim/schedulers.py, for baseline JCT tables over many
// windows or whole traces, where the Python oracle's per-event loop is
// the bottleneck. It implements EXACTLY the oracle's semantics (held
// against it, and against the JAX package's engine, by
// tests/test_torch_oracle.py):
//
//   - gang all-or-nothing admission; jobs may span nodes, so feasibility
//     depends only on TOTAL free GPUs — per-node placement provably cannot
//     change any finish time and is not tracked here;
//   - preemption preserves attained service (RUNNING -> PENDING);
//   - time advances to min(next arrival, next completion, policy wake);
//     completions process before arrivals at the same instant (tolerance
//     1e-9, matching OracleSim.advance_to);
//   - policies: FIFO / SJF (non-preemptive greedy-skip over the pending
//     order) and SRTF / Tiresias-2D-LAS (preemptive greedy-budget prefix
//     admission over all in-system jobs, schedulers.py::schedule_step).
//
// Keys are frozen while a job is PENDING in all four policies (submit /
// duration / remaining / discretized attained service), so the pending set
// lives in an ordered std::multiset and each decision round walks it only
// until the free-GPU budget is exhausted; running jobs' keys (which do
// drift) are re-sorted fresh each round (|running| <= cluster capacity).
//
// C ABI (ctypes, see native/__init__.py):
//   run_baseline_native(n_jobs, submit[], duration[], gpus[],
//                       capacity, policy, thresholds[], n_thresholds,
//                       finish_out[], start_out[]) -> events (>=0) or
//                       error (<0); start_out = first-start times (the
//                       OracleSim.start surface; +inf if never started)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <set>
#include <vector>

namespace {

constexpr double INF = std::numeric_limits<double>::infinity();
constexpr double EPS = 1e-9;

enum Status : int8_t { NOT_ARRIVED = 0, PENDING = 1, RUNNING = 2, DONE = 3 };
enum Policy : int { FIFO = 0, SJF = 1, SRTF = 2, TIRESIAS = 3 };

struct Key {
  double k1, k2;
  int id;
  bool operator<(const Key& o) const {
    if (k1 != o.k1) return k1 < o.k1;
    if (k2 != o.k2) return k2 < o.k2;
    return id < o.id;
  }
};

struct Engine {
  int n;
  const double* submit;
  const double* duration;
  const int* gpus;
  int capacity;
  int policy;
  std::vector<double> thresholds;

  std::vector<int8_t> status;
  std::vector<double> remaining;
  std::vector<double> finish;
  std::vector<double> start;
  double clock = 0.0;
  int free_total;
  int n_done = 0;

  std::vector<int> arrival_order;  // job ids sorted by (submit, id)
  size_t next_arrival = 0;         // index into arrival_order
  std::multiset<Key> pending;      // frozen keys
  std::vector<int> running;

  double attained(int j) const {
    return (duration[j] - remaining[j]) * gpus[j];
  }

  double tier(int j) const {
    // Tiresias discretized queue index = count(thresholds <= attained),
    // matching np.searchsorted(th, attained, side="right")
    const double a = attained(j);
    size_t q = 0;
    while (q < thresholds.size() && a >= thresholds[q]) ++q;
    return static_cast<double>(q);
  }

  Key key_of(int j) const {
    switch (policy) {
      case FIFO: return {submit[j], 0.0, j};
      case SJF:  return {duration[j], 0.0, j};
      case SRTF: return {remaining[j], 0.0, j};
      default:   return {tier(j), submit[j], j};  // TIRESIAS
    }
  }

  void init() {
    status.assign(n, NOT_ARRIVED);
    remaining.assign(n, 0.0);
    finish.assign(n, INF);
    start.assign(n, INF);
    for (int j = 0; j < n; ++j) remaining[j] = duration[j];
    free_total = capacity;
    arrival_order.resize(n);
    for (int j = 0; j < n; ++j) arrival_order[j] = j;
    std::sort(arrival_order.begin(), arrival_order.end(), [&](int a, int b) {
      if (submit[a] != submit[b]) return submit[a] < submit[b];
      return a < b;
    });
    process_arrivals();
  }

  void process_arrivals() {
    while (next_arrival < arrival_order.size()) {
      const int j = arrival_order[next_arrival];
      if (submit[j] > clock) break;
      status[j] = PENDING;
      pending.insert(key_of(j));
      ++next_arrival;
    }
  }

  double next_event_time() const {
    double t = INF;
    if (next_arrival < arrival_order.size())
      t = submit[arrival_order[next_arrival]];
    for (const int j : running) t = std::min(t, clock + remaining[j]);
    return t;
  }

  // OracleSim.advance_to: completions (<= t within EPS) before arrivals.
  double advance_to(double t) {
    if (!std::isfinite(t)) return 0.0;
    const double dt = t - clock;
    clock = t;
    size_t w = 0;
    for (size_t i = 0; i < running.size(); ++i) {
      const int j = running[i];
      remaining[j] -= dt;
      if (remaining[j] <= EPS) {
        status[j] = DONE;
        finish[j] = t;
        remaining[j] = 0.0;
        free_total += gpus[j];
        ++n_done;
      } else {
        running[w++] = j;
      }
    }
    running.resize(w);
    process_arrivals();
    return dt;
  }

  void place(int j) {  // caller guarantees demand <= free_total
    free_total -= gpus[j];
    status[j] = RUNNING;
    start[j] = std::min(start[j], clock);
    running.push_back(j);
  }

  void preempt(int j) {
    free_total += gpus[j];
    status[j] = PENDING;
    pending.insert(key_of(j));  // remaining/attained frozen from here
  }

  // schedulers.py::schedule_step — one decision round at this instant.
  void schedule_step() {
    if (policy == FIFO || policy == SJF) {
      // greedy-skip over the pending order (each job tried independently)
      auto it = pending.begin();
      while (it != pending.end() && free_total > 0) {
        const int j = it->id;
        if (gpus[j] <= free_total) {
          it = pending.erase(it);
          place(j);
        } else {
          ++it;
        }
      }
      return;
    }
    // preemptive: greedy-budget prefix admission over in-system jobs in
    // priority order (merge re-sorted running with the pending multiset)
    std::vector<Key> run_keys;
    run_keys.reserve(running.size());
    for (const int j : running) run_keys.push_back(key_of(j));
    std::sort(run_keys.begin(), run_keys.end());

    int budget = free_total;
    for (const int j : running) budget += gpus[j];

    std::vector<int> admit_pending;
    std::vector<char> admit_running(n, 0);
    auto pit = pending.begin();
    auto rit = run_keys.begin();
    while (budget > 0 && (pit != pending.end() || rit != run_keys.end())) {
      const bool take_pending =
          rit == run_keys.end() ||
          (pit != pending.end() && *pit < *rit);
      const int j = take_pending ? pit->id : rit->id;
      if (gpus[j] <= budget) {
        budget -= gpus[j];
        if (take_pending) admit_pending.push_back(j);
        else admit_running[j] = 1;
      }
      if (take_pending) ++pit; else ++rit;
    }
    // preempt running jobs that fell out of the admitted set...
    std::vector<int> still;
    still.reserve(running.size());
    for (const int j : running) {
      if (admit_running[j]) still.push_back(j);
      else preempt(j);
    }
    running.swap(still);
    // ...then place admitted pending jobs (always feasible: total-GPU
    // budget admission == gang feasibility when jobs span nodes)
    for (const int j : admit_pending) {
      pending.erase(key_of(j));
      place(j);
    }
  }

  // tiresias::next_wake — earliest demotion-threshold crossing.
  double next_wake() const {
    if (policy != TIRESIAS) return INF;
    double t = INF;
    for (const int j : running) {
      const double a = attained(j);
      for (const double th : thresholds) {
        if (th > a) {
          t = std::min(t, clock + (th - a) / gpus[j]);
          break;
        }
      }
    }
    return t;
  }

  // schedulers.py::run_scheduler event loop.
  int64_t run(int64_t max_events) {
    init();
    for (int64_t e = 0; e < max_events; ++e) {
      schedule_step();
      if (n_done == n) return e;
      const double t = std::min(next_event_time(), next_wake());
      if (!std::isfinite(t)) return -2;  // deadlock
      if (advance_to(t) <= 0.0 && n_done != n) {
        if (advance_to(next_event_time()) == 0.0) return -3;  // no progress
      }
    }
    return -4;  // max_events exceeded
  }
};

}  // namespace

extern "C" int64_t run_baseline_native(
    int n_jobs, const double* submit, const double* duration,
    const int* gpus, int capacity, int policy, const double* thresholds,
    int n_thresholds, double* finish_out, double* start_out) {
  if (n_jobs < 0 || capacity <= 0 || policy < 0 || policy > 3) return -1;
  for (int j = 0; j < n_jobs; ++j)
    if (gpus[j] > capacity || gpus[j] <= 0 || duration[j] <= 0.0) return -1;
  Engine eng;
  eng.n = n_jobs;
  eng.submit = submit;
  eng.duration = duration;
  eng.gpus = gpus;
  eng.capacity = capacity;
  eng.policy = policy;
  eng.thresholds.assign(thresholds, thresholds + n_thresholds);
  std::sort(eng.thresholds.begin(), eng.thresholds.end());
  const int64_t events = eng.run(10'000'000LL);
  if (events < 0) return events;
  for (int j = 0; j < n_jobs; ++j) {
    finish_out[j] = eng.finish[j];
    start_out[j] = eng.start[j];
  }
  return events;
}
