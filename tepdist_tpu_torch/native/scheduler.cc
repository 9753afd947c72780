// Native task-scheduler simulation core.
//
// Reference parity: the discrete-event simulation hot loop of
// TaskScheduler::Schedule (reference: pjrt/task_scheduler.{h,cc} —
// ClusterState::ScheduleNextTask / MarkTaskDoneByTime per device until
// AllFinished). The Python layer builds the DAG, computes per-task
// PRIORITY RANKS (the schedule policy: standard 1F1B or Megatron
// interleaved-1F1B — reference GROUP_SCHED_COUNT candidate schedules +
// Reorder post-passes), and interprets the result; this core runs the
// event-driven simulation, which dominates planner time for large
// (stage x micro) DAGs.
//
// A task starts only when every parent has FINISHED in simulated time and
// all its devices are free at the current instant; the 1F1B window is a
// hard admission gate (a forward of a new micro may not start while
// `window` micros are in flight on its stage). Mirrors
// tepdist_tpu/runtime/task_scheduler.py::_simulate_py exactly (asserted
// bit-identical in tests).
//
// Build: g++ -O2 -shared -fPIC scheduler.cc -o libtepdist_sched.so

#include <cstdint>
#include <functional>
#include <queue>
#include <set>
#include <tuple>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

enum TaskKind : int32_t {
  kComputeFwd = 0,
  kComputeBwd = 1,
  kOther = 2,
};

}  // namespace

extern "C" int tepdist_schedule(
    int32_t n_tasks,
    const int32_t* kind,          // TaskKind per task
    const double* duration,
    const double* occupancy,      // device-hold time (<= duration for async transport)
    const int32_t* stage,
    const int32_t* micro,
    const int64_t* rank,          // policy priority rank per task
    const int32_t* dev_offsets,   // CSR [n_tasks+1]
    const int32_t* dev_ids,
    const int32_t* child_offsets, // CSR [n_tasks+1]
    const int32_t* child_ids,
    const int32_t* n_parents,
    int32_t window,
    int32_t* out_order,           // [n_tasks]
    double* out_start,            // [n_tasks]
    double* out_finish) {         // [n_tasks]
  std::vector<int32_t> indeg(n_parents, n_parents + n_tasks);
  std::unordered_map<int32_t, double> dev_free;
  // inflight[stage] = micros with fwd STARTED, bwd not FINISHED.
  std::unordered_map<int32_t, std::set<int32_t>> inflight;

  std::vector<int32_t> pool;  // time-ready (all parents finished)
  pool.reserve(n_tasks);
  for (int32_t t = 0; t < n_tasks; ++t) {
    if (indeg[t] == 0) pool.push_back(t);
  }

  using Ev = std::pair<double, int32_t>;  // (finish time, task id)
  std::priority_queue<Ev, std::vector<Ev>, std::greater<Ev>> events;
  double t_now = 0.0;
  int32_t done = 0;

  using Prio = std::pair<int64_t, int32_t>;  // rank, id
  auto try_start = [&]() -> bool {
    int32_t best = -1;
    size_t best_idx = 0;
    Prio best_pr{};
    for (size_t pi = 0; pi < pool.size(); ++pi) {
      int32_t t = pool[pi];
      bool devs_free = true;
      for (int32_t i = dev_offsets[t]; i < dev_offsets[t + 1]; ++i) {
        auto it = dev_free.find(dev_ids[i]);
        if (it != dev_free.end() && it->second > t_now) {
          devs_free = false;
          break;
        }
      }
      if (!devs_free) continue;
      bool is_fwd = kind[t] == kComputeFwd;
      if (is_fwd && window > 0) {
        auto& s = inflight[stage[t]];
        if (!s.count(micro[t]) && (int32_t)s.size() >= window) {
          continue;  // 1F1B gate: stage window full
        }
      }
      Prio pr{rank[t], t};
      if (best < 0 || pr < best_pr) {
        best = t;
        best_idx = pi;
        best_pr = pr;
      }
    }
    if (best < 0) return false;
    pool.erase(pool.begin() + best_idx);
    double fin = t_now + duration[best];
    double rel = t_now + occupancy[best];
    out_order[done] = best;
    out_start[best] = t_now;
    out_finish[best] = fin;
    ++done;
    for (int32_t i = dev_offsets[best]; i < dev_offsets[best + 1]; ++i) {
      dev_free[dev_ids[i]] = rel;
    }
    if (kind[best] == kComputeFwd) inflight[stage[best]].insert(micro[best]);
    events.push({fin, best});
    if (rel < fin) events.push({rel, -1});  // async release: wake the scan
    return true;
  };

  while (done < n_tasks) {
    while (try_start()) {
    }
    if (events.empty()) return 1;  // deadlock (cycle or gated forever)
    t_now = events.top().first;
    // Drain every completion at this instant before starting more work.
    while (!events.empty() && events.top().first == t_now) {
      int32_t t = events.top().second;
      events.pop();
      if (t < 0) continue;  // sentinel: device-release wake only
      if (kind[t] == kComputeBwd) inflight[stage[t]].erase(micro[t]);
      for (int32_t i = child_offsets[t]; i < child_offsets[t + 1]; ++i) {
        int32_t c = child_ids[i];
        if (--indeg[c] == 0) pool.push_back(c);
      }
    }
  }
  return 0;
}
