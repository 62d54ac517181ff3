// Scheduling core — the cluster-resource math of the runtime, in C++.
//
// Parity: reference src/ray/raylet/scheduling/cluster_resource_scheduler.h
// (feasibility + hybrid policy, hybrid_scheduling_policy.h:48) and
// src/ray/gcs/.../policy/bundle_scheduling_policy.cc (PACK / SPREAD /
// STRICT_* bundle placement).  The Python raylet/GCS marshal their
// resource tables into flat double matrices and call through ctypes;
// semantics here must match the Python fallbacks in
// ray_tpu/core/raylet.py (_pick_spillback) and ray_tpu/core/gcs.py
// (_plan_bundles) bit for bit — tests/test_sched_core.py checks
// cross-agreement on randomized instances.
//
// Layout conventions: matrices are row-major [n_nodes x n_res] /
// [n_bundles x n_res]; node order is the caller's candidate order (the
// Python side pre-sorts by TPU slice/worker for topology-aware packing).

#include <cstddef>
#include <cstdint>
#include <vector>

extern "C" {

// Does `demand` fit into `avail` (one node row)?
static bool fits_row(const double* avail, const double* demand, int n_res) {
  for (int r = 0; r < n_res; ++r) {
    if (avail[r] < demand[r]) return false;
  }
  return true;
}

static void take_row(double* avail, const double* demand, int n_res) {
  for (int r = 0; r < n_res; ++r) avail[r] -= demand[r];
}

// Hybrid / spread task-spillback choice (reference
// hybrid_scheduling_policy.h): returns the index of the chosen REMOTE
// node, or -1 to keep the task local.
//
//   strategy: 0 = hybrid (stay local while under `spread_threshold`
//                 and locally feasible; else least-loaded remote)
//             1 = spread (always prefer the least-loaded remote that
//                 fits)
//   node_avail:  [n_nodes x n_res] remote candidates' available
//   node_load:   [n_nodes] queued-work proxy per candidate
//   demand:      [n_res]
//   local_utilization / spread_threshold: the local pack/spread knobs
//   local_feasible: 1 if this node could EVER run the demand
int rtpu_sched_pick_node(const double* node_avail, const int64_t* node_load,
                         int n_nodes, int n_res, const double* demand,
                         int strategy, double local_utilization,
                         double spread_threshold, int local_feasible) {
  int best = -1;
  int64_t best_load = 0;
  for (int i = 0; i < n_nodes; ++i) {
    if (!fits_row(node_avail + (size_t)i * n_res, demand, n_res)) continue;
    if (best < 0 || node_load[i] < best_load) {
      best = i;
      best_load = node_load[i];
    }
  }
  if (best < 0) return -1;
  if (strategy == 1) return best;  // SPREAD: always hand off
  // hybrid: pack locally until the threshold (if this node can ever
  // serve the demand), then spread to the least-loaded fitting remote
  if (local_utilization < spread_threshold && local_feasible) return -1;
  return best;
}

// Bundle placement (reference bundle_scheduling_policy.cc).
//   strategy: 0 = PACK, 1 = SPREAD, 2 = STRICT_PACK, 3 = STRICT_SPREAD
//   avail:    [n_nodes x n_res], mutated with the tentative placement
//   bundles:  [n_bundles x n_res]
//   out_assignment: [n_bundles] node indices
// Returns 1 on success, 0 if infeasible under the strategy.
int rtpu_sched_place_bundles(double* avail, int n_nodes, int n_res,
                             const double* bundles, int n_bundles,
                             int strategy, int* out_assignment) {
  const bool strict_pack = strategy == 2;
  const bool strict_spread = strategy == 3;
  const bool pack = strategy == 0 || strict_pack;

  if (pack) {
    // try one node for the whole gang first (one ICI domain)
    for (int i = 0; i < n_nodes; ++i) {
      std::vector<double> trial(avail + (size_t)i * n_res,
                                avail + (size_t)(i + 1) * n_res);
      bool all_fit = true;
      for (int b = 0; b < n_bundles; ++b) {
        const double* bundle = bundles + (size_t)b * n_res;
        if (fits_row(trial.data(), bundle, n_res)) {
          take_row(trial.data(), bundle, n_res);
        } else {
          all_fit = false;
          break;
        }
      }
      if (all_fit) {
        for (int b = 0; b < n_bundles; ++b) {
          out_assignment[b] = i;
          take_row(avail + (size_t)i * n_res, bundles + (size_t)b * n_res,
                   n_res);
        }
        return 1;
      }
    }
    if (strict_pack) return 0;
    // soft pack: greedy first-fit node by node (caller's sort order
    // keeps same-slice nodes adjacent)
    for (int b = 0; b < n_bundles; ++b) {
      const double* bundle = bundles + (size_t)b * n_res;
      int chosen = -1;
      for (int i = 0; i < n_nodes; ++i) {
        if (fits_row(avail + (size_t)i * n_res, bundle, n_res)) {
          chosen = i;
          break;
        }
      }
      if (chosen < 0) return 0;
      out_assignment[b] = chosen;
      take_row(avail + (size_t)chosen * n_res, bundle, n_res);
    }
    return 1;
  }

  // SPREAD / STRICT_SPREAD: fresh node per bundle when possible
  std::vector<char> used(n_nodes, 0);
  for (int b = 0; b < n_bundles; ++b) {
    const double* bundle = bundles + (size_t)b * n_res;
    int chosen = -1;
    for (int i = 0; i < n_nodes; ++i) {
      if (!used[i] && fits_row(avail + (size_t)i * n_res, bundle, n_res)) {
        chosen = i;
        break;
      }
    }
    if (chosen < 0) {
      if (strict_spread) return 0;
      for (int i = 0; i < n_nodes; ++i) {
        if (fits_row(avail + (size_t)i * n_res, bundle, n_res)) {
          chosen = i;
          break;
        }
      }
      if (chosen < 0) return 0;
    }
    out_assignment[b] = chosen;
    used[chosen] = 1;
    take_row(avail + (size_t)chosen * n_res, bundle, n_res);
  }
  return 1;
}

}  // extern "C"
