// Host bucketing core of the port's ragged-batch padding: the exact DP that
// splits a numel-sorted list of N tensors into M buckets minimizing the
// total padded cost (cost of a bucket [s, e] = numel[e] * (e - s + 1)).
// O(M*N^2) time, O(M*N) space.  It is host control-plane work, so it is
// plain C++ with a C ABI, loaded through ctypes
// (di_hpc_tpu_torch/utils/native.py).  The Python DP with the same
// semantics and the same tie-breaking (the smallest split point among equal
// costs) is di_hpc_tpu_torch/origin/padding.py:oracle_split_group.

#include <cstdint>
#include <limits>
#include <vector>

extern "C" {

// numels: ascending numel per tensor, length n (1-indexed internally).
// positions_out: length group+1; positions_out[0] = 0, positions_out[group] = n.
// Returns the minimal total padded cost, or -1 on infeasible input.
int64_t oracle_split_group(const int64_t* numels, int64_t n, int64_t group,
                           int64_t* positions_out) {
    if (n <= 0 || group <= 0 || group > n) return -1;
    const int64_t INF = std::numeric_limits<int64_t>::max() / 4;

    // f[j][i] = min cost of covering the first i tensors with j buckets.
    // parent[j][i] = split point k (last bucket is (k, i]).
    std::vector<std::vector<int64_t>> f(group + 1, std::vector<int64_t>(n + 1, INF));
    std::vector<std::vector<int64_t>> parent(group + 1, std::vector<int64_t>(n + 1, -1));
    f[0][0] = 0;

    for (int64_t i = 1; i <= n; ++i) {
        const int64_t numel_i = numels[i - 1];
        for (int64_t j = 1; j <= group; ++j) {
            int64_t best = INF, best_k = -1;
            for (int64_t k = 0; k < i; ++k) {
                if (f[j - 1][k] >= INF) continue;
                const int64_t cost = f[j - 1][k] + numel_i * (i - k);
                if (cost < best) { best = cost; best_k = k; }
            }
            f[j][i] = best;
            parent[j][i] = best_k;
        }
    }

    if (f[group][n] >= INF) return -1;

    int64_t pos = n;
    for (int64_t j = group; j >= 1; --j) {
        positions_out[j] = pos;
        pos = parent[j][pos];
    }
    positions_out[0] = 0;
    return f[group][n];
}

}  // extern "C"
