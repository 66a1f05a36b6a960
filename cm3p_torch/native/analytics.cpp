// CM3P analytics core: PCA, k-means, L2-normalize, k-NN.
//
// C++ reimplementation of the reference visualizer's Rust/WASM compute
// kernels (lib.rs) with identical algorithmic
// semantics so browser and offline paths agree:
//   * PCA: mean-center + 8-step power iteration, 2 components, Gram-Schmidt
//     on the second, project to 2-D (lib.rs:82-235)
//   * k-means: LCG-seeded first centroid, max-distance init for the rest,
//     Lloyd <= 10 iterations with early stop (lib.rs:242-364)
//   * normalize: per-row L2, zero rows left as zero (lib.rs:371-422)
//   * k-NN: cosine distance on normalized rows, partial selection
//     (lib.rs:448-487)
// plus chunked variants for data-parallel sharding (lib_parallel.rs) and
// std::thread parallel drivers for the offline path.
//
// Built as a native shared library by cm3p_torch/native/__init__.py, which
// holds the ctypes bindings and the numpy versions of every function.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <functional>
#include <thread>
#include <vector>

#define CM3P_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

inline float dotf(const float* __restrict a, const float* __restrict b, size_t d) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    size_t k = 0;
    for (; k + 4 <= d; k += 4) {
        s0 += a[k] * b[k];
        s1 += a[k + 1] * b[k + 1];
        s2 += a[k + 2] * b[k + 2];
        s3 += a[k + 3] * b[k + 3];
    }
    float s = s0 + s1 + s2 + s3;
    for (; k < d; ++k) s += a[k] * b[k];
    return s;
}

inline float sqdistf(const float* __restrict a, const float* __restrict b, size_t d) {
    float s = 0.f;
    for (size_t k = 0; k < d; ++k) {
        float c = a[k] - b[k];
        s += c * c;
    }
    return s;
}

inline uint32_t lcg_next(uint32_t& state) {
    state = state * 1664525u + 1013904223u;
    return state;
}

inline float lcg_unit(uint32_t& state) {
    return static_cast<float>(lcg_next(state)) / 4294967296.0f;
}

void run_threads(size_t n_items, int n_threads, const std::function<void(size_t, size_t)>& fn) {
    if (n_threads <= 1 || n_items < 2) {
        fn(0, n_items);
        return;
    }
    size_t nt = std::min<size_t>(n_threads, n_items);
    size_t chunk = (n_items + nt - 1) / nt;
    std::vector<std::thread> threads;
    for (size_t t = 0; t < nt; ++t) {
        size_t start = t * chunk;
        size_t end = std::min(start + chunk, n_items);
        if (start >= end) break;
        threads.emplace_back(fn, start, end);
    }
    for (auto& th : threads) th.join();
}

}  // namespace

// ---------------------------------------------------------------------- PCA

CM3P_EXPORT void cm3p_pca(const float* emb, size_t n, size_t d, uint32_t seed, float* out /* n*2 */) {
    if (n == 0 || d == 0) return;

    std::vector<float> mean(d, 0.f);
    for (size_t i = 0; i < n; ++i) {
        const float* row = emb + i * d;
        for (size_t j = 0; j < d; ++j) mean[j] += row[j];
    }
    const float inv_n = 1.0f / static_cast<float>(n);
    for (size_t j = 0; j < d; ++j) mean[j] *= inv_n;

    uint32_t rng = seed ? seed : 12345u;
    std::vector<std::vector<float>> components;

    for (int c = 0; c < 2; ++c) {
        std::vector<float> ev(d);
        for (size_t j = 0; j < d; ++j) ev[j] = lcg_unit(rng) - 0.5f;
        float mag = std::sqrt(dotf(ev.data(), ev.data(), d));
        if (mag > 0.f)
            for (auto& v : ev) v /= mag;

        std::vector<float> next(d);
        for (int it = 0; it < 8; ++it) {
            std::fill(next.begin(), next.end(), 0.f);
            for (size_t i = 0; i < n; ++i) {
                const float* row = emb + i * d;
                float score = 0.f;
                for (size_t j = 0; j < d; ++j) score += (row[j] - mean[j]) * ev[j];
                for (size_t j = 0; j < d; ++j) next[j] += score * (row[j] - mean[j]);
            }
            mag = std::sqrt(dotf(next.data(), next.data(), d));
            if (mag > 0.f) {
                for (size_t j = 0; j < d; ++j) ev[j] = next[j] / mag;
            }
        }

        if (c == 1) {
            const auto& u = components[0];
            float proj = dotf(u.data(), ev.data(), d);
            for (size_t j = 0; j < d; ++j) ev[j] -= proj * u[j];
            mag = std::sqrt(dotf(ev.data(), ev.data(), d));
            if (mag > 0.f)
                for (auto& v : ev) v /= mag;
        }
        components.push_back(std::move(ev));
    }

    const auto& c0 = components[0];
    const auto& c1 = components[1];
    for (size_t i = 0; i < n; ++i) {
        const float* row = emb + i * d;
        float x = 0.f, y = 0.f;
        for (size_t j = 0; j < d; ++j) {
            float v = row[j] - mean[j];
            x += v * c0[j];
            y += v * c1[j];
        }
        out[i * 2] = x;
        out[i * 2 + 1] = y;
    }
}

// chunked variant: compute mean-centered projection of [start, end) given
// precomputed components (worker-pool sharding, lib_parallel.rs:66-180)
CM3P_EXPORT void cm3p_pca_project_chunk(
    const float* emb, size_t n, size_t d, const float* mean, const float* comp0, const float* comp1,
    size_t start, size_t end, float* out /* (end-start)*2 */) {
    if (end > n) end = n;
    for (size_t i = start; i < end; ++i) {
        const float* row = emb + i * d;
        float x = 0.f, y = 0.f;
        for (size_t j = 0; j < d; ++j) {
            float v = row[j] - mean[j];
            x += v * comp0[j];
            y += v * comp1[j];
        }
        out[(i - start) * 2] = x;
        out[(i - start) * 2 + 1] = y;
    }
}

// ------------------------------------------------------------------- kmeans

CM3P_EXPORT void cm3p_kmeans(
    const float* emb, size_t n, size_t d, size_t k, uint32_t seed, int8_t* labels) {
    if (n == 0 || k == 0) return;

    std::vector<float> centroids(k * d, 0.f);
    uint32_t rng = seed;

    // first centroid by LCG; the rest by max distance to nearest centroid
    size_t first = static_cast<size_t>(lcg_next(rng)) % n;
    std::memcpy(centroids.data(), emb + first * d, d * sizeof(float));

    std::vector<float> distances(n, std::numeric_limits<float>::infinity());
    for (size_t i = 1; i < k; ++i) {
        const float* prev = centroids.data() + (i - 1) * d;
        for (size_t j = 0; j < n; ++j) {
            float dist = sqdistf(emb + j * d, prev, d);
            if (dist < distances[j]) distances[j] = dist;
        }
        size_t max_idx = 0;
        float max_dist = 0.f;
        for (size_t j = 0; j < n; ++j) {
            if (distances[j] > max_dist) {
                max_dist = distances[j];
                max_idx = j;
            }
        }
        std::memcpy(centroids.data() + i * d, emb + max_idx * d, d * sizeof(float));
    }

    std::fill(labels, labels + n, 0);
    std::vector<float> sums(k * d);
    std::vector<size_t> counts(k);

    for (int iter = 0; iter < 10; ++iter) {
        size_t changed = 0;
        for (size_t i = 0; i < n; ++i) {
            const float* row = emb + i * d;
            float min_dist = std::numeric_limits<float>::infinity();
            int8_t best = labels[i];
            for (size_t c = 0; c < k; ++c) {
                float dist = sqdistf(row, centroids.data() + c * d, d);
                if (dist < min_dist) {
                    min_dist = dist;
                    best = static_cast<int8_t>(c);
                }
            }
            if (labels[i] != best) {
                ++changed;
                labels[i] = best;
            }
        }
        if (iter > 0 && changed == 0) break;

        std::fill(sums.begin(), sums.end(), 0.f);
        std::fill(counts.begin(), counts.end(), 0);
        for (size_t i = 0; i < n; ++i) {
            size_t c = static_cast<size_t>(labels[i]);
            ++counts[c];
            const float* row = emb + i * d;
            float* sum = sums.data() + c * d;
            for (size_t j = 0; j < d; ++j) sum[j] += row[j];
        }
        for (size_t c = 0; c < k; ++c) {
            if (counts[c] > 0) {
                float inv = 1.0f / static_cast<float>(counts[c]);
                float* cen = centroids.data() + c * d;
                const float* sum = sums.data() + c * d;
                for (size_t j = 0; j < d; ++j) cen[j] = sum[j] * inv;
            }
        }
    }
}

// chunked assign step: labels for rows [start, end) given centroids
CM3P_EXPORT size_t cm3p_kmeans_assign_chunk(
    const float* emb, size_t n, size_t d, const float* centroids, size_t k,
    size_t start, size_t end, int8_t* labels /* full array */) {
    if (end > n) end = n;
    size_t changed = 0;
    for (size_t i = start; i < end; ++i) {
        const float* row = emb + i * d;
        float min_dist = std::numeric_limits<float>::infinity();
        int8_t best = labels[i];
        for (size_t c = 0; c < k; ++c) {
            float dist = sqdistf(row, centroids + c * d, d);
            if (dist < min_dist) {
                min_dist = dist;
                best = static_cast<int8_t>(c);
            }
        }
        if (labels[i] != best) {
            ++changed;
            labels[i] = best;
        }
    }
    return changed;
}

// chunked update step: partial sums/counts over rows [start, end)
CM3P_EXPORT void cm3p_kmeans_update_chunk(
    const float* emb, size_t n, size_t d, const int8_t* labels, size_t k,
    size_t start, size_t end, float* sums /* k*d */, uint32_t* counts /* k */) {
    if (end > n) end = n;
    std::fill(sums, sums + k * d, 0.f);
    std::fill(counts, counts + k, 0u);
    for (size_t i = start; i < end; ++i) {
        size_t c = static_cast<size_t>(labels[i]);
        ++counts[c];
        const float* row = emb + i * d;
        float* sum = sums + c * d;
        for (size_t j = 0; j < d; ++j) sum[j] += row[j];
    }
}

// threaded driver: same semantics as cm3p_kmeans, assignment parallelized
CM3P_EXPORT void cm3p_kmeans_parallel(
    const float* emb, size_t n, size_t d, size_t k, uint32_t seed, int n_threads, int8_t* labels) {
    if (n == 0 || k == 0) return;

    std::vector<float> centroids(k * d, 0.f);
    uint32_t rng = seed;
    size_t first = static_cast<size_t>(lcg_next(rng)) % n;
    std::memcpy(centroids.data(), emb + first * d, d * sizeof(float));
    std::vector<float> distances(n, std::numeric_limits<float>::infinity());
    for (size_t i = 1; i < k; ++i) {
        const float* prev = centroids.data() + (i - 1) * d;
        run_threads(n, n_threads, [&](size_t s, size_t e) {
            for (size_t j = s; j < e; ++j) {
                float dist = sqdistf(emb + j * d, prev, d);
                if (dist < distances[j]) distances[j] = dist;
            }
        });
        size_t max_idx = 0;
        float max_dist = 0.f;
        for (size_t j = 0; j < n; ++j)
            if (distances[j] > max_dist) {
                max_dist = distances[j];
                max_idx = j;
            }
        std::memcpy(centroids.data() + i * d, emb + max_idx * d, d * sizeof(float));
    }

    std::fill(labels, labels + n, 0);
    for (int iter = 0; iter < 10; ++iter) {
        std::atomic<size_t> changed{0};
        run_threads(n, n_threads, [&](size_t s, size_t e) {
            changed += cm3p_kmeans_assign_chunk(emb, n, d, centroids.data(), k, s, e, labels);
        });
        if (iter > 0 && changed.load() == 0) break;

        std::vector<float> sums(k * d, 0.f);
        std::vector<size_t> counts(k, 0);
        for (size_t i = 0; i < n; ++i) {
            size_t c = static_cast<size_t>(labels[i]);
            ++counts[c];
            const float* row = emb + i * d;
            float* sum = sums.data() + c * d;
            for (size_t j = 0; j < d; ++j) sum[j] += row[j];
        }
        for (size_t c = 0; c < k; ++c)
            if (counts[c] > 0) {
                float inv = 1.0f / static_cast<float>(counts[c]);
                for (size_t j = 0; j < d; ++j) centroids[c * d + j] = sums[c * d + j] * inv;
            }
    }
}

// ---------------------------------------------------------------- normalize

CM3P_EXPORT void cm3p_normalize(const float* emb, size_t n, size_t d, float* out) {
    for (size_t i = 0; i < n; ++i) {
        const float* row = emb + i * d;
        float* dst = out + i * d;
        float sum_sq = dotf(row, row, d);
        if (sum_sq == 0.f) {
            std::memset(dst, 0, d * sizeof(float));
            continue;
        }
        float inv = 1.0f / std::sqrt(sum_sq);
        for (size_t j = 0; j < d; ++j) dst[j] = row[j] * inv;
    }
}

CM3P_EXPORT void cm3p_normalize_chunk(const float* emb, size_t n, size_t d, size_t start, size_t end, float* out) {
    if (end > n) end = n;
    cm3p_normalize(emb + start * d, end - start, d, out);
}

CM3P_EXPORT void cm3p_normalize_parallel(const float* emb, size_t n, size_t d, int n_threads, float* out) {
    run_threads(n, n_threads, [&](size_t s, size_t e) { cm3p_normalize(emb + s * d, e - s, d, out + s * d); });
}

// ---------------------------------------------------------------------- kNN

CM3P_EXPORT size_t cm3p_knn(
    const float* normalized, size_t n, size_t d, size_t query_idx, size_t n_neighbors,
    uint32_t* indices, float* dists) {
    if (query_idx >= n || n < 2) return 0;
    const float* query = normalized + query_idx * d;

    std::vector<std::pair<float, uint32_t>> results;
    results.reserve(n - 1);
    for (size_t i = 0; i < n; ++i) {
        if (i == query_idx) continue;
        float dist = 1.0f - dotf(query, normalized + i * d, d);
        results.emplace_back(dist, static_cast<uint32_t>(i));
    }
    size_t k = std::min(n_neighbors, results.size());
    std::nth_element(results.begin(), results.begin() + (k - 1), results.end());
    results.resize(k);
    std::sort(results.begin(), results.end());
    for (size_t i = 0; i < k; ++i) {
        indices[i] = results[i].second;
        dists[i] = results[i].first;
    }
    return k;
}

