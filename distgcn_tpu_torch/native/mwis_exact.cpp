// Exact MWIS solver: branch & bound with bitset graphs + weighted reductions.
//
// Native replacement for the reference's external Gurobi MIP benchmark
// (heuristics.py:327-355 `mlp_gurobi`): solves max-weight independent set
// exactly on the conflict graphs used throughout (N ~ 1e2..1e3, sparse).
//
// Techniques:
//  - adjacency as dynamic bitsets (u64 words), candidate sets likewise;
//  - reductions inside the search: isolated vertices taken greedily via the
//    branching rule; neighborhood-weight domination (w_v >= sum w(N(v) ∩ P))
//    takes v outright;
//  - branching on the max-degree candidate (include N[v]-removal / exclude);
//  - upper bound: greedy weighted clique cover of the candidate set
//    (UB = sum over cliques of max weight), computed on the bitset rows;
//  - time limit with best-found reporting (status 1 = timeout).
//
// Also exports fast host-side greedy / local-greedy (LGS) solvers matching
// the semantics of heuristics.py:13-35 / :77-116 for CPU-bound simulation
// loops.
//
// The PyTorch port's own copy of distgcn_tpu/native/mwis_exact.cpp.
// Build: g++ -O3 -march=native -shared -fPIC mwis_exact.cpp -o <library>
// (distgcn_tpu_torch/solvers/exact.py builds it into build/native/).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <algorithm>
#include <chrono>
#include <cmath>

namespace {

using Clock = std::chrono::steady_clock;

struct BitGraph {
    int n;
    int words;
    std::vector<uint64_t> rows;  // n * words

    BitGraph(int n_) : n(n_), words((n_ + 63) / 64), rows((size_t)n_ * ((n_ + 63) / 64), 0) {}
    inline uint64_t* row(int v) { return rows.data() + (size_t)v * words; }
    inline const uint64_t* row(int v) const { return rows.data() + (size_t)v * words; }
    inline void add_edge(int u, int v) {
        row(u)[v >> 6] |= (1ULL << (v & 63));
        row(v)[u >> 6] |= (1ULL << (u & 63));
    }
};

inline int popcount_and(const uint64_t* a, const uint64_t* b, int words) {
    int c = 0;
    for (int i = 0; i < words; ++i) c += __builtin_popcountll(a[i] & b[i]);
    return c;
}



// ---------------------------------------------------------------------------
// Dinic max-flow (double capacities) for the Nemhauser-Trotter LP reduction.
struct Dinic {
    struct Edge { int to; double cap; int rev; };
    std::vector<std::vector<Edge>> adj;
    std::vector<int> level, iter;
    int n;
    explicit Dinic(int n_) : adj(n_), level(n_), iter(n_), n(n_) {}
    void add_edge(int a, int b, double cap) {
        adj[a].push_back({b, cap, (int)adj[b].size()});
        adj[b].push_back({a, 0.0, (int)adj[a].size() - 1});
    }
    bool bfs(int s, int t) {
        std::fill(level.begin(), level.end(), -1);
        std::vector<int> q{s};
        level[s] = 0;
        for (size_t qi = 0; qi < q.size(); ++qi) {
            int v = q[qi];
            for (auto& e : adj[v])
                if (e.cap > 1e-12 && level[e.to] < 0) {
                    level[e.to] = level[v] + 1;
                    q.push_back(e.to);
                }
        }
        return level[t] >= 0;
    }
    double dfs(int v, int t, double f) {
        if (v == t) return f;
        for (int& i = iter[v]; i < (int)adj[v].size(); ++i) {
            Edge& e = adj[v][i];
            if (e.cap > 1e-12 && level[v] < level[e.to]) {
                double d = dfs(e.to, t, std::min(f, e.cap));
                if (d > 1e-12) {
                    e.cap -= d;
                    adj[e.to][e.rev].cap += d;
                    return d;
                }
            }
        }
        return 0.0;
    }
    double max_flow(int s, int t) {
        double flow = 0.0;
        while (bfs(s, t)) {
            std::fill(iter.begin(), iter.end(), 0);
            double f;
            while ((f = dfs(s, t, 1e300)) > 1e-12) flow += f;
        }
        return flow;
    }
    // residual reachability from s
    std::vector<char> reachable(int s) {
        std::vector<char> vis(n, 0);
        std::vector<int> q{s};
        vis[s] = 1;
        for (size_t qi = 0; qi < q.size(); ++qi)
            for (auto& e : adj[q[qi]])
                if (e.cap > 1e-12 && !vis[e.to]) {
                    vis[e.to] = 1;
                    q.push_back(e.to);
                }
        return vis;
    }
};

// Exact MWIS with:
//  - reduction loop: isolated-positive take; neighborhood-weight domination;
//  - connected-component decomposition at every subproblem;
//  - matching bound: UB = sum(w+) - sum over greedy maximal matching of
//    min(w_u, w_v) (any IS loses at least min(w) per matched edge);
//  - greedy incumbent per component, max-degree branching.
struct Solver {
    const BitGraph& g;
    const double* w;
    int words;
    Clock::time_point deadline;
    bool timed_out;
    long long nodes_visited;

    Solver(const BitGraph& g_, const double* w_, double limit_sec)
        : g(g_), w(w_), words(g_.words), timed_out(false), nodes_visited(0) {
        t_start = Clock::now();
        deadline = t_start + std::chrono::duration_cast<Clock::duration>(
            std::chrono::duration<double>(limit_sec));
        if (const char* e = std::getenv("DISTGCN_BNB_LOG"))
            log_improve = atoi(e) != 0;
    }

    inline void note_best(double v, const char* tag) const {
        if (log_improve)
            fprintf(stderr, "[bnb] t=%.2fs %s best=%.6f\n",
                    std::chrono::duration<double>(Clock::now() - t_start)
                        .count(), tag, v);
    }

    // optional externally-supplied incumbent (0/1 per vertex) — e.g. the
    // best feasible point another portfolio arm (mwis_cut) found; its
    // restriction to any subproblem P is a valid lower bound
    std::vector<int8_t> init;

    // Optional dual-bound constraint pool from the root cutting-plane LP
    // (clique rows + odd-cycle rows + singleton repairs). Each constraint j
    // is a vertex set C_j (bitset), a dual weight y_j > 0 and an integer
    // capacity rhs_j, with the dual-feasibility invariant (enforced by the
    // Python side, solvers/exact.mwis_root_duals):
    //     sum_{j: v in C_j} y_j >= w_v   for every vertex v.
    // Then for any IS S inside the live set P:
    //     w(S) <= sum_j y_j |S ∩ C_j| <= sum_j y_j min(rhs_j, |C_j ∩ P|),
    // a subproblem bound that inherits the root LP's tightness (constraints
    // are static; only the |C_j ∩ P| popcounts change per node).
    std::vector<uint64_t> con_bits;   // n_cons x words
    std::vector<double> con_y, con_rhs;
    int n_cons = 0;
    // incumbent-improvement log + phase profile (DISTGCN_BNB_LOG=1)
    bool log_improve = false;
    Clock::time_point t_start;
    mutable double t_reduce = 0, t_split = 0, t_match = 0, t_dual = 0,
                   t_nt = 0;
    mutable long long c_node = 0, c_prune_dual = 0, c_prune_split = 0,
                      c_prune_match = 0;

    void print_profile() const {
        if (!log_improve) return;
        fprintf(stderr,
                "[bnb] profile: nodes=%lld reduce=%.1fs split=%.1fs(%lld) "
                "match=%.1fs(%lld) dual=%.1fs(%lld) nt=%.1fs\n",
                nodes_visited, t_reduce, t_split, c_prune_split,
                t_match, c_prune_match, t_dual, c_prune_dual, t_nt);
    }

    // UB(P) from the static dual pool; bails out early (returning +inf)
    // once the partial sum already exceeds `stop` (no prune possible).
    double dual_ub(const uint64_t* P, double stop) const {
        double s = 0.0;
        const uint64_t* cb = con_bits.data();
        for (int j = 0; j < n_cons; ++j, cb += words) {
            int cnt = popcount_and(cb, P, words);
            if (cnt) {
                double cap = con_rhs[j];
                s += con_y[j] * (cnt < cap ? (double)cnt : cap);
                if (s > stop) return 1e300;
            }
        }
        return s;
    }

    inline bool in(const uint64_t* P, int v) const {
        return P[v >> 6] & (1ULL << (v & 63));
    }
    inline void clearbit(uint64_t* P, int v) const {
        P[v >> 6] &= ~(1ULL << (v & 63));
    }

    template <class F>
    inline void for_each(const uint64_t* P, F f) const {
        for (int wi = 0; wi < words; ++wi) {
            uint64_t word = P[wi];
            while (word) {
                int b = __builtin_ctzll(word);
                word &= word - 1;
                f(wi * 64 + b);
            }
        }
    }

    double nbr_sum_pos(const uint64_t* P, int v) const {
        double s = 0.0;
        const uint64_t* rv = g.row(v);
        for (int wi = 0; wi < words; ++wi) {
            uint64_t word = rv[wi] & P[wi];
            while (word) {
                int b = __builtin_ctzll(word);
                word &= word - 1;
                double x = w[wi * 64 + b];
                if (x > 0) s += x;
            }
        }
        return s;
    }

    // UB = sum(w+) - matching loss (greedy maximal matching).
    double bound(const uint64_t* P) const {
        double sum_pos = 0.0;
        for_each(P, [&](int v) { if (w[v] > 0) sum_pos += w[v]; });
        std::vector<uint64_t> unmatched(P, P + words);
        double loss = 0.0;
        for (int wi = 0; wi < words; ++wi) {
            uint64_t word = unmatched[wi];
            while (word) {
                int b = __builtin_ctzll(word);
                word &= word - 1;
                int v = wi * 64 + b;
                if (!(unmatched[v >> 6] & (1ULL << (v & 63)))) continue;
                const uint64_t* rv = g.row(v);
                int u = -1;
                for (int wj = 0; wj < words && u < 0; ++wj) {
                    uint64_t cand = rv[wj] & unmatched[wj];
                    if (wj == (v >> 6)) cand &= ~(1ULL << (v & 63));
                    if (cand) u = wj * 64 + __builtin_ctzll(cand);
                }
                if (u >= 0) {
                    double lo = std::min(std::max(w[v], 0.0), std::max(w[u], 0.0));
                    loss += lo;
                    unmatched[v >> 6] &= ~(1ULL << (v & 63));
                    unmatched[u >> 6] &= ~(1ULL << (u & 63));
                    word = unmatched[wi];  // refresh current word
                }
            }
        }
        return sum_pos - loss;
    }

    // greedy (stable (w,-id) order) on P; returns value, fills sel
    double greedy_in(const uint64_t* P, std::vector<int>& sel) const {
        static thread_local std::vector<int> cand;
        cand.clear();
        // id order == (w desc, id asc) order after the entry relabeling
        for_each(P, [&](int v) { cand.push_back(v); });
        std::vector<uint64_t> blocked(words, 0);
        double val = 0.0;
        for (int v : cand) {
            if (w[v] <= 0) break;
            if (blocked[v >> 6] & (1ULL << (v & 63))) continue;
            sel.push_back(v);
            val += w[v];
            const uint64_t* rv = g.row(v);
            for (int wi = 0; wi < words; ++wi) blocked[wi] |= rv[wi];
        }
        return val;
    }


    // (1,2)-swap local search: improve an IS by removing one member and
    // inserting two non-adjacent non-members from its freed neighborhood.
    // Sharpens B&B incumbents cheaply (the classic NPHard local search).
    double improve_12(const uint64_t* P, std::vector<int>& sel,
                      double val) const {
        std::vector<uint64_t> selmask(words, 0);
        for (int v : sel) selmask[v >> 6] |= (1ULL << (v & 63));
        bool improved = true;
        while (improved && !timed_out) {
            improved = false;
            for (size_t si = 0; si < sel.size(); ++si) {
                int v = sel[si];
                // candidates: in P, not in sel, all sel-neighbors == v only
                std::vector<int> cand;
                for_each(P, [&](int u) {
                    if (selmask[u >> 6] & (1ULL << (u & 63))) return;
                    // u's selected neighbors must be exactly {v}
                    const uint64_t* ru = g.row(u);
                    for (int wk = 0; wk < words; ++wk) {
                        uint64_t hit = ru[wk] & selmask[wk];
                        if (wk == (v >> 6)) hit &= ~(1ULL << (v & 63));
                        if (hit) return;
                    }
                    if (ru[v >> 6] & (1ULL << (v & 63))) cand.push_back(u);
                });
                // best pair of non-adjacent candidates
                double bestgain = 0.0;
                int ba = -1, bb = -1;
                for (size_t i = 0; i < cand.size(); ++i)
                    for (size_t j = i + 1; j < cand.size(); ++j) {
                        int a = cand[i], b = cand[j];
                        if (g.row(a)[b >> 6] & (1ULL << (b & 63))) continue;
                        double gain = w[a] + w[b] - w[v];
                        if (gain > bestgain + 1e-12) {
                            bestgain = gain;
                            ba = a;
                            bb = b;
                        }
                    }
                if (ba >= 0) {
                    selmask[v >> 6] &= ~(1ULL << (v & 63));
                    selmask[ba >> 6] |= (1ULL << (ba & 63));
                    selmask[bb >> 6] |= (1ULL << (bb & 63));
                    sel[si] = ba;
                    sel.push_back(bb);
                    val += bestgain;
                    improved = true;
                }
            }
        }
        return val;
    }


    // GRASP incumbent: randomized greedy restarts (multiplicative weight
    // noise, xorshift PRNG) + (1,2)-swap local search. Finds optimal or
    // near-optimal solutions fast; B&B then mostly proves optimality.
    double grasp(const uint64_t* P, std::vector<int>& best_sel,
                 int restarts = 24) const {
        double best = greedy_in(P, best_sel);
        best = improve_12(P, best_sel, best);
        uint64_t rng = 0x9e3779b97f4a7c15ULL;
        auto rnd = [&]() {
            rng ^= rng << 13;
            rng ^= rng >> 7;
            rng ^= rng << 17;
            return (double)(rng >> 11) / (double)(1ULL << 53);
        };
        std::vector<int> cand0;
        for_each(P, [&](int v) { cand0.push_back(v); });
        for (int r = 0; r < restarts && !timed_out; ++r) {
            double amp = 0.1 + 0.4 * rnd();
            std::vector<std::pair<double, int>> order;
            order.reserve(cand0.size());
            for (int v : cand0)
                order.push_back({-w[v] * (1.0 + amp * (rnd() - 0.5)), v});
            std::sort(order.begin(), order.end());
            std::vector<uint64_t> blocked(words, 0);
            std::vector<int> sel;
            double val = 0.0;
            for (auto& pr : order) {
                int v = pr.second;
                if (w[v] <= 0) continue;
                if (blocked[v >> 6] & (1ULL << (v & 63))) continue;
                sel.push_back(v);
                val += w[v];
                const uint64_t* rv = g.row(v);
                for (int wi = 0; wi < words; ++wi) blocked[wi] |= rv[wi];
            }
            val = improve_12(P, sel, val);
            if (val > best) {
                best = val;
                best_sel = sel;
            }
        }
        return best;
    }

    // ILS incumbent: iterated local search on top of GRASP (Andrade-style
    // force-insert perturbation). Each iteration force-inserts 1-3 random
    // non-members (evicting their selected neighbors), repairs greedily over
    // the freed candidates, re-runs the (1,2)-swap, and accepts improvements.
    // Far stronger incumbents than GRASP alone on sparse cores (where the
    // 60 s GRASP incumbent sat 4% below optimal on ER n=300 p=0.033 tails).
    double ils(const uint64_t* P, std::vector<int>& best_sel,
               double budget_sec) const {
        double best = grasp(P, best_sel);
        auto end = Clock::now() + std::chrono::duration_cast<Clock::duration>(
            std::chrono::duration<double>(budget_sec));
        uint64_t rng = 0xd1b54a32d192ed03ULL;
        auto rnd_u32 = [&]() {
            rng ^= rng << 13; rng ^= rng >> 7; rng ^= rng << 17;
            return (uint32_t)(rng >> 32);
        };
        std::vector<int> cand0;
        // id order == weight order: repair already inserts heaviest-first
        for_each(P, [&](int v) { if (w[v] > 0) cand0.push_back(v); });
        if (cand0.empty()) return best;
        std::vector<int> cur = best_sel;
        double curval = best;
        std::vector<uint64_t> selmask(words);
        int stall = 0;
        long long iters = 0;
        // weighted sampling table (prob ∝ w²): heavy vertices are likelier
        // members of better optima, so force-inserting them escapes the
        // light-vertex plateaus uniform sampling cannot leave
        std::vector<double> cumw2(cand0.size());
        double acc2 = 0.0;
        for (size_t i = 0; i < cand0.size(); ++i) {
            acc2 += w[cand0[i]] * w[cand0[i]];
            cumw2[i] = acc2;
        }
        auto sample_weighted = [&]() {
            double r = (double)(rnd_u32()) / 4294967296.0 * acc2;
            size_t lo = std::lower_bound(cumw2.begin(), cumw2.end(), r)
                        - cumw2.begin();
            return cand0[std::min(lo, cand0.size() - 1)];
        };
        while (Clock::now() < end && !timed_out) {
            ++iters;
            std::fill(selmask.begin(), selmask.end(), 0);
            for (int v : cur) selmask[v >> 6] |= (1ULL << (v & 63));
            std::vector<int> sel = cur;
            double val = curval;
            if (stall >= 25 && stall % 25 == 0 && !sel.empty()) {
                // ball destroy: drop all selected within distance 2 of a
                // random member, rebuild with noisy greedy — the large-move
                // escape for plateaus the force-insert kicks cannot leave
                int c = sel[rnd_u32() % sel.size()];
                std::vector<uint64_t> ball(g.row(c), g.row(c) + words);
                ball[c >> 6] |= (1ULL << (c & 63));
                std::vector<uint64_t> ball2 = ball;
                for_each(ball.data(), [&](int u) {
                    const uint64_t* ru = g.row(u);
                    for (int wi = 0; wi < words; ++wi) ball2[wi] |= ru[wi];
                });
                std::vector<int> keep;
                for (int u : sel) {
                    if (ball2[u >> 6] & (1ULL << (u & 63))) {
                        val -= w[u];
                        selmask[u >> 6] &= ~(1ULL << (u & 63));
                    } else keep.push_back(u);
                }
                sel.swap(keep);
            } else {
                // force-insert k vertices: weighted draws half the time
                int k = 1 + (int)(rnd_u32() % (stall > 20 ? 3u : 1u));
                for (int t = 0; t < k; ++t) {
                    int v = (rnd_u32() & 1) ? sample_weighted()
                                            : cand0[rnd_u32() % cand0.size()];
                    if (selmask[v >> 6] & (1ULL << (v & 63))) continue;
                    // evict selected neighbors of v
                    const uint64_t* rv = g.row(v);
                    std::vector<int> keep;
                    keep.reserve(sel.size() + 1);
                    for (int u : sel) {
                        if (rv[u >> 6] & (1ULL << (u & 63))) {
                            val -= w[u];
                            selmask[u >> 6] &= ~(1ULL << (u & 63));
                        } else keep.push_back(u);
                    }
                    sel.swap(keep);
                    sel.push_back(v);
                    selmask[v >> 6] |= (1ULL << (v & 63));
                    val += w[v];
                }
            }
            // repair: greedy over remaining candidates not blocked by sel,
            // heaviest-first normally, weight-noised while stalled
            std::vector<uint64_t> blocked(words, 0);
            for (int u : sel) {
                const uint64_t* ru = g.row(u);
                for (int wi = 0; wi < words; ++wi) blocked[wi] |= ru[wi];
                blocked[u >> 6] |= (1ULL << (u & 63));
            }
            auto insert_all = [&](const std::vector<int>& order) {
                for (int u : order) {
                    if (blocked[u >> 6] & (1ULL << (u & 63))) continue;
                    if (!in(P, u)) continue;
                    sel.push_back(u);
                    val += w[u];
                    const uint64_t* ru = g.row(u);
                    for (int wi = 0; wi < words; ++wi) blocked[wi] |= ru[wi];
                    blocked[u >> 6] |= (1ULL << (u & 63));
                }
            };
            if (stall >= 25) {
                std::vector<std::pair<double, int>> noisy;
                noisy.reserve(cand0.size());
                for (int u : cand0) {
                    double amp = 0.3 * ((double)rnd_u32() / 4294967296.0
                                        - 0.5);
                    noisy.push_back({-w[u] * (1.0 + amp), u});
                }
                std::sort(noisy.begin(), noisy.end());
                std::vector<int> order;
                order.reserve(noisy.size());
                for (auto& pr : noisy) order.push_back(pr.second);
                insert_all(order);
            } else {
                insert_all(cand0);
            }
            val = improve_12(P, sel, val);
            if (val > curval - 1e-12) {   // accept equal-or-better (plateau)
                cur.swap(sel);
                curval = val;
                if (val > best + 1e-12) {
                    best = val;
                    best_sel = cur;
                    stall = 0;
                    note_best(best, "ils");
                } else ++stall;
            } else ++stall;
            if (stall > 150) {  // alternate: restart from best / fresh GRASP
                if ((iters / 150) & 1) {
                    std::vector<int> fresh;
                    double fval = grasp(P, fresh, 6);
                    cur.swap(fresh);
                    curval = fval;
                } else {
                    cur = best_sel;
                    curval = best;
                }
                stall = 0;
            }
        }
        return best;
    }

    // split off the connected component of P containing v
    void component_of(const uint64_t* P, int v, uint64_t* comp) const {
        std::fill(comp, comp + words, 0);
        comp[v >> 6] |= (1ULL << (v & 63));
        bool grew = true;
        while (grew) {
            grew = false;
            for (int wi = 0; wi < words; ++wi) {
                uint64_t word = comp[wi];
                while (word) {
                    int b = __builtin_ctzll(word);
                    word &= word - 1;
                    const uint64_t* rv = g.row(wi * 64 + b);
                    for (int wj = 0; wj < words; ++wj) {
                        uint64_t add = rv[wj] & P[wj] & ~comp[wj];
                        if (add) { comp[wj] |= add; grew = true; }
                    }
                }
            }
        }
    }



    // Weight-splitting clique cover UB: repeatedly grow a maximal clique
    // among positive-residual vertices (seeded at the max-residual vertex,
    // extended greedily by residual), charge its minimum residual to the
    // bound and subtract it from all members. A feasible fractional clique
    // cover, so UB = sum of charges; much tighter than sum-of-clique-maxima
    // when weights vary (the classic WLMC/TSM-style bound).
    double split_cover_ub(const uint64_t* P, double stop = 1e300) const {
        static thread_local std::vector<double> r;
        static thread_local std::vector<uint64_t> act, common;
        static thread_local std::vector<int> members;
        r.assign(g.n, 0.0);
        act.assign(words, 0);
        bool any = false;
        for_each(P, [&](int v) {
            if (w[v] > 0) {
                r[v] = w[v];
                act[v >> 6] |= (1ULL << (v & 63));
                any = true;
            }
        });
        if (!any) return 0.0;
        common.resize(words);
        double ub = 0.0;
        int si = 0;  // forward-only seed word (act bits only ever clear)
        for (;;) {
            while (si < words && !act[si]) ++si;
            if (si == words) break;
            if (ub > stop) return 1e300;  // no prune possible: bail
            // seed = heaviest residual-positive vertex (ids are in weight
            // order after the entry relabeling)
            int seed = si * 64 + __builtin_ctzll(act[si]);
            const uint64_t* rs = g.row(seed);
            for (int wi = 0; wi < words; ++wi) common[wi] = rs[wi] & act[wi];
            double mn = r[seed];
            members.clear();
            members.push_back(seed);
            // extend greedily by weight over common ∩ act, re-intersecting
            // with each member's neighborhood as we go — O(degree) bit work
            // per clique instead of a scan over every live candidate
            for (int wi = 0; wi < words; ++wi) {
                uint64_t word = common[wi];
                while (word) {
                    int b = __builtin_ctzll(word);
                    word &= word - 1;
                    int v = wi * 64 + b;
                    members.push_back(v);
                    if (r[v] < mn) mn = r[v];
                    const uint64_t* rv = g.row(v);
                    for (int wj = wi; wj < words; ++wj) common[wj] &= rv[wj];
                    word &= common[wi];
                }
            }
            ub += mn;
            for (int v : members) {
                r[v] -= mn;
                if (r[v] <= 1e-12) act[v >> 6] &= ~(1ULL << (v & 63));
            }
        }
        return ub;
    }

    // Partial-cover branching set (WLMC-style, adapted to weighted IS
    // with weight-splitting covers): build the same greedy split cover but
    // stop charging once the accumulated bound reaches `limit`. Writing
    // w_v = sum of v's clique charges + residual r_v exactly, any IS S has
    //   w(S) = sum_j c_j |S∩C_j| + sum_{v∈S} r_v <= sum_j c_j + r(S∩R)
    // with R = {r_v > 0}. So if the charges alone reach <= limit, every
    // improving IS (w(S) > limit) must intersect R — branch |R| ways with
    // accumulated exclusions instead of binary include/exclude.
    // Returns true if the FULL cover already proves ub <= limit (prune);
    // otherwise fills R (bitset) with the branching set.
    bool split_cover_branchset(const uint64_t* P, double limit,
                               std::vector<uint64_t>& R) const {
        static thread_local std::vector<double> r;
        static thread_local std::vector<uint64_t> act, common;
        static thread_local std::vector<int> members;
        r.assign(g.n, 0.0);
        act.assign(words, 0);
        bool any = false;
        for_each(P, [&](int v) {
            if (w[v] > 0) {
                r[v] = w[v];
                act[v >> 6] |= (1ULL << (v & 63));
                any = true;
            }
        });
        if (!any) return true;
        common.resize(words);
        double ub = 0.0;
        int si = 0;
        for (;;) {
            while (si < words && !act[si]) ++si;
            if (si == words) return ub <= limit + 1e-12;  // cover complete
            if (ub >= limit - 1e-12) break;  // budget exhausted -> branch set
            int seed = si * 64 + __builtin_ctzll(act[si]);
            const uint64_t* rs = g.row(seed);
            for (int wi = 0; wi < words; ++wi) common[wi] = rs[wi] & act[wi];
            double mn = r[seed];
            members.clear();
            members.push_back(seed);
            for (int wi = 0; wi < words; ++wi) {
                uint64_t word = common[wi];
                while (word) {
                    int b = __builtin_ctzll(word);
                    word &= word - 1;
                    int v = wi * 64 + b;
                    members.push_back(v);
                    if (r[v] < mn) mn = r[v];
                    const uint64_t* rv = g.row(v);
                    for (int wj = wi; wj < words; ++wj) common[wj] &= rv[wj];
                    word &= common[wi];
                }
            }
            double c = std::min(mn, limit - ub);  // partial final charge ok
            ub += c;
            for (int v : members) {
                r[v] -= c;
                if (r[v] <= 1e-12) act[v >> 6] &= ~(1ULL << (v & 63));
            }
        }
        R.assign(act.begin(), act.end());
        return false;
    }

    // Greedy weighted clique cover UB: iterate by weight desc, first-fit into
    // cliques; UB = sum of each clique's max weight. Tight on dense cores.
    double clique_cover_ub(const uint64_t* P) const {
        static thread_local std::vector<int> cand;
        cand.clear();
        // ids are weight-ordered after the entry relabeling: no sort
        for_each(P, [&](int v) { if (w[v] > 0) cand.push_back(v); });
        // each clique tracked as the intersection of members' neighborhoods:
        // v can join clique c iff v is adjacent to all members <=> v in mask_c
        static thread_local std::vector<std::vector<uint64_t>> masks;
        masks.clear();
        double ub = 0.0;
        for (int v : cand) {
            bool placed = false;
            for (auto& m : masks) {
                if (m[v >> 6] & (1ULL << (v & 63))) {
                    const uint64_t* rv = g.row(v);
                    for (int wi = 0; wi < words; ++wi) m[wi] &= rv[wi];
                    placed = true;
                    break;
                }
            }
            if (!placed) {
                masks.emplace_back(g.row(v), g.row(v) + words);
                ub += w[v];
            }
        }
        return ub;
    }

    // Simplicial reduction: if N(v) ∩ P is a clique and w_v >= max nbr
    // weight, take v. Domination removal: for adjacent (u, v) with
    // N[u] ⊆ N[v] and w_v <= w_u, remove v. Returns value added.
    double reduce_struct(std::vector<uint64_t>& P, std::vector<int>& out) {
        double base = 0.0;
        bool changed = true;
        std::vector<uint64_t> nbrP(words);
        while (changed && !timed_out) {
            changed = false;
            for (int wi = 0; wi < words; ++wi) {
                uint64_t word = P[wi];
                while (word) {
                    int b = __builtin_ctzll(word);
                    word &= word - 1;
                    int v = wi * 64 + b;
                    const uint64_t* rv = g.row(v);
                    for (int wj = 0; wj < words; ++wj)
                        nbrP[wj] = rv[wj] & P[wj];
                    int deg = 0;
                    for (int wj = 0; wj < words; ++wj)
                        deg += __builtin_popcountll(nbrP[wj]);
                    if (deg == 0) {
                        if (w[v] > 0) { base += w[v]; out.push_back(v); }
                        clearbit(P.data(), v);
                        changed = true;
                        continue;
                    }
                    if (deg <= 16) {
                        // clique-neighborhood removal: take v if w_v covers
                        // the best any IS can extract from N(v) (UB by
                        // weighted clique cover of the neighborhood)
                        double nb_ub = clique_cover_ub(nbrP.data());
                        if (w[v] >= nb_ub && w[v] > 0) {
                            base += w[v];
                            out.push_back(v);
                            for (int wk = 0; wk < words; ++wk)
                                P[wk] &= ~nbrP[wk];
                            clearbit(P.data(), v);
                            changed = true;
                            word &= P[wi];  // drop removed bits from snapshot
                            continue;
                        }
                    }
                    // domination removal over neighbors u of v:
                    // if N[u] ⊆ N[v] and w_v <= w_u -> drop v
                    for (int wj = 0; wj < words; ++wj) {
                        uint64_t nw = nbrP[wj];
                        bool dropped = false;
                        while (nw) {
                            int nb = __builtin_ctzll(nw);
                            nw &= nw - 1;
                            int u = wj * 64 + nb;
                            if (w[u] < w[v]) continue;
                            if (w[u] == w[v] && u > v) continue;  // break sym
                            const uint64_t* ru = g.row(u);
                            bool subset = true;
                            for (int wk = 0; wk < words; ++wk) {
                                uint64_t nu = ru[wk] & P[wk];
                                if (wk == (v >> 6)) nu &= ~(1ULL << (v & 63));
                                uint64_t nv = nbrP[wk];
                                if (wk == (u >> 6)) nv &= ~(1ULL << (u & 63));
                                if (nu & ~nv) { subset = false; break; }
                            }
                            if (subset) {  // N_P[u] ⊆ N_P[v], w_v <= w_u
                                clearbit(P.data(), v);
                                changed = true;
                                dropped = true;
                                break;
                            }
                        }
                        if (dropped) break;
                    }
                }
            }
        }
        return base;
    }

    // Nemhauser-Trotter LP persistency on the (positive-weight) subgraph P:
    // solve the half-integral vertex-cover LP via bipartite max-flow on the
    // double cover; vertices with x_v = 1 go into the solution, x_v = 0 are
    // removed, and only the x = 1/2 core remains in P. Returns added value.
    double nt_reduce(std::vector<uint64_t>& P, std::vector<int>& out,
                     double* core_half = nullptr) {
        if (core_half) *core_half = 0.0;
        std::vector<int> verts;
        for_each(P.data(), [&](int v) { verts.push_back(v); });
        int cnt = (int)verts.size();
        if (cnt == 0) return 0.0;
        std::vector<int> pos(g.n, -1);
        for (int i = 0; i < cnt; ++i) pos[verts[i]] = i;
        int S = 2 * cnt, T = 2 * cnt + 1;
        Dinic din(2 * cnt + 2);
        for (int i = 0; i < cnt; ++i) {
            din.add_edge(S, i, w[verts[i]]);
            din.add_edge(cnt + i, T, w[verts[i]]);
        }
        for (int i = 0; i < cnt; ++i) {
            const uint64_t* rv = g.row(verts[i]);
            for (int wj = 0; wj < words; ++wj) {
                uint64_t word = rv[wj] & P[wj];
                while (word) {
                    int b = __builtin_ctzll(word);
                    word &= word - 1;
                    int j = pos[wj * 64 + b];
                    din.add_edge(i, cnt + j, 1e300);
                }
            }
        }
        din.max_flow(S, T);
        std::vector<char> Z = din.reachable(S);
        double base = 0.0;
        for (int i = 0; i < cnt; ++i) {
            int v = verts[i];
            int yl = Z[i] ? 0 : 1;          // L-side cover membership
            int yr = Z[cnt + i] ? 1 : 0;    // R-side cover membership
            int y2 = yl + yr;               // 2*y_v in {0, 1, 2}
            if (y2 == 0) {                  // x_v = 1: persistently in MWIS
                base += w[v];
                out.push_back(v);
                clearbit(P.data(), v);
            } else if (y2 == 2) {           // x_v = 0: persistently out
                clearbit(P.data(), v);
            } else if (core_half) {        // y2 == 1: half core, keep
                *core_half += 0.5 * w[v];
            }
        }
        return base;
    }

    // exact value of subgraph P; appends chosen vertices into out
    double solve(std::vector<uint64_t> P, std::vector<int>& out) {
        double base = 0.0;
        // nonpositive-weight vertices never belong to an optimal MWIS
        for_each(P.data(), [&](int v) {
            if (w[v] <= 0) clearbit(P.data(), v);
        });
        // ---- reduction loop
        for (;;) {
            if (timed_out) break;
            bool changed = false;
            for (int wi = 0; wi < words; ++wi) {
                uint64_t word = P[wi];
                while (word) {
                    int b = __builtin_ctzll(word);
                    word &= word - 1;
                    int v = wi * 64 + b;
                    int deg = popcount_and(g.row(v), P.data(), words);
                    if (deg == 0) {
                        if (w[v] > 0) { base += w[v]; out.push_back(v); }
                        clearbit(P.data(), v);
                        changed = true;
                    } else if (w[v] > 0 && w[v] >= nbr_sum_pos(P.data(), v)) {
                        base += w[v];
                        out.push_back(v);
                        const uint64_t* rv = g.row(v);
                        for (int wj = 0; wj < words; ++wj) P[wj] &= ~rv[wj];
                        clearbit(P.data(), v);
                        changed = true;
                        word = P[wi];  // refresh
                    }
                }
            }
            if (!changed) break;
        }
        if (!timed_out) base += reduce_struct(P, out);
        // ---- LP persistency (Nemhauser-Trotter)
        if (!timed_out) base += nt_reduce(P, out);
        int first = -1;
        for (int wi = 0; wi < words && first < 0; ++wi)
            if (P[wi]) first = wi * 64 + __builtin_ctzll(P[wi]);
        if (first < 0) return base;
        if (timed_out) {
            std::vector<int> sel;
            base += greedy_in(P.data(), sel);
            out.insert(out.end(), sel.begin(), sel.end());
            return base;
        }
        // ---- component decomposition
        std::vector<uint64_t> comp(words);
        component_of(P.data(), first, comp.data());
        bool whole = true;
        for (int wi = 0; wi < words; ++wi)
            if (comp[wi] != P[wi]) { whole = false; break; }
        if (!whole) {
            std::vector<uint64_t> rest(words);
            for (int wi = 0; wi < words; ++wi) rest[wi] = P[wi] & ~comp[wi];
            base += solve(comp, out);
            base += solve(std::move(rest), out);
            return base;
        }
        // ---- single connected component: B&B
        std::vector<int> best_sel;
        double remain = std::chrono::duration<double>(
            deadline - Clock::now()).count();
        int live = 0;
        for (int wi = 0; wi < words; ++wi)
            live += __builtin_popcountll(P[wi]);
        // ILS budget: worth it only on cores big enough to have a gap.
        // On hard cores (n300 ER tails) the B&B alone improves the
        // incumbent far slower than the ILS does, so large cores get a
        // double-digit share of the budget (overridable via env).
        double frac = 0.05, cap = 3.0;
        if (live >= 150) { frac = 0.12; cap = 40.0; }
        else if (live >= 80) { frac = 0.08; cap = 10.0; }
        if (const char* e = std::getenv("DISTGCN_ILS_FRAC")) frac = atof(e);
        if (const char* e = std::getenv("DISTGCN_ILS_CAP")) cap = atof(e);
        double budget = (live >= 40)
            ? std::min(std::max(frac * remain, 0.0), cap) : 0.0;
        double best = (budget > 0.01 ? ils(P.data(), best_sel, budget)
                                     : grasp(P.data(), best_sel)) - 1e-12;
        note_best(best, "start");
        if (!init.empty()) {
            // restriction of the external incumbent to this component,
            // sharpened by the 2-improvement, may beat the ILS start
            std::vector<int> isel;
            double ival = 0.0;
            for_each(P.data(), [&](int v) {
                if (init[v]) { isel.push_back(v); ival += w[v]; }
            });
            if (!isel.empty()) {
                ival = improve_12(P.data(), isel, ival);
                if (ival - 1e-12 > best) {
                    best = ival - 1e-12;
                    best_sel = isel;
                }
            }
        }
        std::vector<int> cur;
        bnb(P, 0.0, cur, best, best_sel);
        out.insert(out.end(), best_sel.begin(), best_sel.end());
        return base + best;
    }

    void bnb(std::vector<uint64_t>& P, double curval, std::vector<int>& cur,
             double& best, std::vector<int>& best_sel, int depth = 0) {
        if (timed_out) return;
        if ((++nodes_visited & 1023) == 0 && Clock::now() > deadline) {
            timed_out = true;
            return;
        }
        size_t undo_cur = cur.size();
        auto undo = [&]() { cur.resize(undo_cur); };
        Clock::time_point ph0;
        if (log_improve) ph0 = Clock::now();
        auto lap = [&](double& acc) {
            if (!log_improve) return;
            auto now = Clock::now();
            acc += std::chrono::duration<double>(now - ph0).count();
            ph0 = now;
        };
        // cheap in-node reduction: isolated takes + low-degree
        // clique-neighborhood takes (popcount-only tests)
        std::vector<uint64_t> nbrP(words);
        bool changed = true;
        int pick = -1, pick_deg = -1;
        while (changed) {
            changed = false;
            pick = -1;
            pick_deg = -1;
            for (int wi = 0; wi < words; ++wi) {
                uint64_t word = P[wi];
                while (word) {
                    int b = __builtin_ctzll(word);
                    word &= word - 1;
                    int v = wi * 64 + b;
                    const uint64_t* rv = g.row(v);
                    int deg = 0;
                    for (int wj = 0; wj < words; ++wj) {
                        nbrP[wj] = rv[wj] & P[wj];
                        deg += __builtin_popcountll(nbrP[wj]);
                    }
                    if (deg == 0) {
                        if (w[v] > 0) { cur.push_back(v); curval += w[v]; }
                        clearbit(P.data(), v);
                        changed = true;
                        continue;
                    }
                    if (deg <= 3 && w[v] > 0
                        && w[v] >= clique_cover_ub(nbrP.data())) {
                        cur.push_back(v);
                        curval += w[v];
                        for (int wk = 0; wk < words; ++wk) P[wk] &= ~nbrP[wk];
                        clearbit(P.data(), v);
                        changed = true;
                        word &= P[wi];
                        continue;
                    }
                    if (pick < 0 || deg > pick_deg
                        || (deg == pick_deg && w[v] > w[pick])) {
                        pick_deg = deg;
                        pick = v;
                    }
                }
            }
        }
        if (pick < 0) {
            if (curval > best) {
                best = curval;
                best_sel = cur;
                note_best(best, "bnb");
            }
            undo();
            return;
        }
        lap(t_reduce);
        // prune with the cheaper-to-tighter cascade: the static root-LP dual
        // bound (tight near the root, where pruning pays most), then greedy
        // clique covers (tight on dense cores), then the matching bound
        // (tight on sparse ones) — take all three.
        if (n_cons) {
            bool cut = curval + dual_ub(P.data(), best - curval)
                       <= best + 1e-12;
            lap(t_dual);
            if (cut) {
                ++c_prune_dual;
                undo();
                return;
            }
        }
        std::vector<uint64_t> bset;
        {
            bool cut = split_cover_branchset(P.data(), best - curval, bset);
            lap(t_split);
            if (cut) {
                ++c_prune_split;
                undo();
                return;
            }
        }
        {
            bool cut = curval + bound(P.data()) <= best + 1e-12;
            lap(t_match);
            if (cut) {
                ++c_prune_match;
                undo();
                return;
            }
        }
        // periodic LP persistency: strong but costly -> shallow depths
        // and big live cores only (profile: Dinic was 28% of node time
        // with most of it spent re-reducing small subtrees)
        int live_here = 0;
        for (int wi = 0; wi < words; ++wi)
            live_here += __builtin_popcountll(P[wi]);
        if (depth % 16 == 0 && live_here >= 128) {
            if (log_improve) ph0 = Clock::now();
            double core_half = 0.0;
            std::vector<uint64_t> Pn(P);
            size_t before = cur.size();
            double taken = nt_reduce(Pn, cur, &core_half);
            lap(t_nt);
            if (curval + taken + core_half <= best + 1e-12) {
                undo();
                return;
            }
            if (taken > 0 || true) {
                // adopt the reduced problem (persistency is exact)
                P.swap(Pn);
                curval += taken;
                // soundness: if NT fixed IN a vertex of the branching set,
                // "improving solutions intersect R" holds trivially for all
                // completions — R no longer constrains them; binary-branch.
                for (size_t i = before; i < cur.size() && !bset.empty(); ++i)
                    if (bset[cur[i] >> 6] & (1ULL << (cur[i] & 63)))
                        bset.clear();
                pick = -1;
                pick_deg = -1;
                for (int wi = 0; wi < words; ++wi) {
                    uint64_t word = P[wi];
                    while (word) {
                        int b = __builtin_ctzll(word);
                        word &= word - 1;
                        int v = wi * 64 + b;
                        int deg = popcount_and(g.row(v), P.data(), words);
                        if (pick < 0 || deg > pick_deg
                            || (deg == pick_deg && w[v] > w[pick])) {
                            pick_deg = deg;
                            pick = v;
                        }
                    }
                }
                if (pick < 0) {
                    if (curval > best) {
                        best = curval;
                        best_sel = cur;
                        note_best(best, "bnb-nt");
                    }
                    undo();
                    return;
                }
            }
        }
        // component decomposition of the core: solve pieces independently
        {
            std::vector<uint64_t> comp(words);
            component_of(P.data(), pick, comp.data());
            bool whole = true;
            for (int wi = 0; wi < words; ++wi)
                if (comp[wi] != P[wi]) { whole = false; break; }
            if (!whole) {
                std::vector<int> sub_sel;
                std::vector<uint64_t> Pc(P);
                double val = curval + solve(std::move(Pc), sub_sel);
                if (val > best) {
                    best = val;
                    best_sel = cur;
                    best_sel.insert(best_sel.end(), sub_sel.begin(),
                                    sub_sel.end());
                }
                undo();
                return;
            }
        }
        // multi-branch on the partial-cover branching set when it is
        // selective enough; otherwise classic binary max-degree branching.
        // NT adoption above may have shrunk P since bset was computed —
        // intersect to stay inside the live set (still a valid cover of
        // every improving solution: removing vertices only shrinks S).
        static const int multibranch = [] {
            const char* e = std::getenv("DISTGCN_MULTIBRANCH");
            return e ? atoi(e) : 0;  // A/B measured a tree-quality
            // REGRESSION vs binary branching on the ER tail (b5: binary
            // proves in 85 s, multibranch times out at 200 s despite 3x
            // the node rate) — default off until the cover/order is tuned
        }();
        int bcnt = 0;
        if (multibranch && !bset.empty())
            for (int wi = 0; wi < words; ++wi) {
                bset[wi] &= P[wi];
                bcnt += __builtin_popcountll(bset[wi]);
            }
        int live_now = 0;
        for (int wi = 0; wi < words; ++wi)
            live_now += __builtin_popcountll(P[wi]);
        if (multibranch && bcnt > 0 && 2 * bcnt <= live_now) {
            static thread_local std::vector<int> Rl;
            Rl.clear();
            for_each(bset.data(), [&](int v) { Rl.push_back(v); });
            if (multibranch == 2)
                std::reverse(Rl.begin(), Rl.end());  // lightest-first
            std::vector<uint64_t> Pex(P);
            std::vector<uint64_t> P1(words);
            for (int v : Rl) {
                // include v (against the accumulated exclusions)
                const uint64_t* rv = g.row(v);
                for (int wi = 0; wi < words; ++wi)
                    P1[wi] = Pex[wi] & ~rv[wi];
                clearbit(P1.data(), v);
                cur.push_back(v);
                bnb(P1, curval + w[v], cur, best, best_sel, depth + 1);
                cur.pop_back();
                if (timed_out) { undo(); return; }
                clearbit(Pex.data(), v);  // exclude v for later branches
            }
            // all of R excluded: cover bound says no improvement possible
            undo();
            return;
        }
        int v = pick;
        // branch 1: include v
        {
            std::vector<uint64_t> P1(P);
            const uint64_t* rv = g.row(v);
            for (int wi = 0; wi < words; ++wi) P1[wi] &= ~rv[wi];
            clearbit(P1.data(), v);
            cur.push_back(v);
            bnb(P1, curval + w[v], cur, best, best_sel, depth + 1);
            cur.pop_back();
        }
        if (timed_out) { undo(); return; }
        // branch 2: exclude v
        {
            std::vector<uint64_t> P2(P);
            clearbit(P2.data(), v);
            bnb(P2, curval, cur, best, best_sel, depth + 1);
        }
        undo();
    }
};

}  // namespace

extern "C" {

// Exact MWIS. adjacency as CSR (indptr[n+1], indices), weights w[n].
// out_sel[n] gets 0/1; returns status 0=optimal 1=timeout(best found).
// init_sel (may be NULL): 0/1 warm-start independent set; its restriction
// to every subproblem seeds the incumbent (portfolio arms hand their best
// feasible point back to the B&B this way).
int mwis_exact_dual(const int32_t*, const int32_t*, const double*, int,
                    double, const int8_t*, const int32_t*, const int32_t*,
                    const double*, const double*, int, int8_t*, double*);

int mwis_exact_ws(const int32_t* indptr, const int32_t* indices,
                  const double* w, int n, double timeout_sec,
                  const int8_t* init_sel,
                  int8_t* out_sel, double* out_val) {
    return mwis_exact_dual(indptr, indices, w, n, timeout_sec, init_sel,
                           nullptr, nullptr, nullptr, nullptr, 0,
                           out_sel, out_val);
}

int mwis_exact(const int32_t* indptr, const int32_t* indices,
               const double* w, int n, double timeout_sec,
               int8_t* out_sel, double* out_val) {
    return mwis_exact_ws(indptr, indices, w, n, timeout_sec, nullptr,
                         out_sel, out_val);
}

// Exact MWIS with a static dual-bound constraint pool from the root
// cutting-plane LP (see Solver::dual_ub). Constraints in CSR-like form:
// con_ptr[n_cons+1] offsets into con_idx (vertex ids), duals con_y[j] > 0,
// capacities con_rhs[j]. The caller (solvers/exact.mwis_root_duals)
// guarantees dual feasibility sum_{j: v in C_j} y_j >= w_v for all v.
int mwis_exact_dual(const int32_t* indptr, const int32_t* indices,
                    const double* w, int n, double timeout_sec,
                    const int8_t* init_sel,
                    const int32_t* con_ptr, const int32_t* con_idx,
                    const double* con_y, const double* con_rhs, int n_cons,
                    int8_t* out_sel, double* out_val) {
    // Relabel vertices by (w desc, id asc) so that inside the solver the
    // id order IS the weight order: every weight-ordered scan (greedy,
    // clique-cover bounds, ILS repair) becomes a plain bitset sweep.
    std::vector<int> perm(n);   // perm[new] = old
    for (int i = 0; i < n; ++i) perm[i] = i;
    std::sort(perm.begin(), perm.end(), [&](int a, int b) {
        return w[a] > w[b] || (w[a] == w[b] && a < b);
    });
    std::vector<int> invp(n);   // invp[old] = new
    for (int i = 0; i < n; ++i) invp[perm[i]] = i;
    std::vector<double> wp(n);
    for (int i = 0; i < n; ++i) wp[i] = w[perm[i]];
    BitGraph g(n);
    for (int v = 0; v < n; ++v)
        for (int32_t e = indptr[v]; e < indptr[v + 1]; ++e)
            if (indices[e] > v) g.add_edge(invp[v], invp[indices[e]]);
    Solver s(g, wp.data(), timeout_sec);
    if (init_sel) {
        s.init.assign(n, 0);
        for (int v = 0; v < n; ++v)
            if (init_sel[v]) s.init[invp[v]] = 1;
    }
    if (n_cons > 0) {
        s.n_cons = n_cons;
        s.con_bits.assign((size_t)n_cons * g.words, 0);
        s.con_y.assign(con_y, con_y + n_cons);
        s.con_rhs.assign(con_rhs, con_rhs + n_cons);
        for (int j = 0; j < n_cons; ++j) {
            uint64_t* cb = s.con_bits.data() + (size_t)j * g.words;
            for (int32_t k = con_ptr[j]; k < con_ptr[j + 1]; ++k) {
                int nv = invp[con_idx[k]];
                cb[nv >> 6] |= (1ULL << (nv & 63));
            }
        }
    }
    std::vector<uint64_t> P(g.words, 0);
    for (int v = 0; v < n; ++v) P[v >> 6] |= (1ULL << (v & 63));
    std::vector<int> chosen;
    double val = s.solve(std::move(P), chosen);
    s.print_profile();
    std::memset(out_sel, 0, n);
    for (int v : chosen) out_sel[perm[v]] = 1;
    *out_val = val;
    return s.timed_out ? 1 : 0;
}

// Centralized greedy (heuristics.py:13-35 semantics, stable tie by id).
double greedy_mwis(const int32_t* indptr, const int32_t* indices,
                   const double* w, int n, int8_t* out_sel) {
    std::vector<int> order(n);
    for (int i = 0; i < n; ++i) order[i] = i;
    std::sort(order.begin(), order.end(),
              [&](int a, int b) { return w[a] > w[b] || (w[a] == w[b] && a < b); });
    std::vector<int8_t> blocked(n, 0);
    double val = 0.0;
    std::memset(out_sel, 0, n);
    for (int v : order) {
        if (blocked[v]) continue;
        out_sel[v] = 1;
        val += w[v];
        for (int32_t e = indptr[v]; e < indptr[v + 1]; ++e)
            blocked[indices[e]] = 1;
    }
    return val;
}

// Local greedy search (heuristics.py:77-116 semantics incl. id tie-break).
// Returns rounds; out_sel in {-1 remaining(never at exit), 0 excluded, 1 in}.
int local_greedy(const int32_t* indptr, const int32_t* indices,
                 const double* w, int n, int8_t* out_sel, double* out_val) {
    std::vector<int8_t> sel(n, -1);
    int rounds = 0;
    bool any = n > 0;
    while (any) {
        any = false;
        ++rounds;
        std::vector<int> winners;
        for (int v = 0; v < n; ++v) {
            if (sel[v] != -1) continue;
            double m = -1e300;
            int tied_min = n + 1;
            bool has = false;
            for (int32_t e = indptr[v]; e < indptr[v + 1]; ++e) {
                int u = indices[e];
                if (sel[u] != -1) continue;
                has = true;
                if (w[u] > m) { m = w[u]; tied_min = u; }
                else if (w[u] == m && u < tied_min) tied_min = u;
            }
            if (!has || w[v] > m || (w[v] == m && v < tied_min))
                winners.push_back(v);
        }
        for (int v : winners) {
            sel[v] = 1;
            for (int32_t e = indptr[v]; e < indptr[v + 1]; ++e)
                if (sel[indices[e]] == -1) sel[indices[e]] = 0;
        }
        for (int v = 0; v < n; ++v) if (sel[v] == -1) { any = true; break; }
        if (winners.empty() && any) break;  // safety; cannot happen
    }
    double val = 0.0;
    for (int v = 0; v < n; ++v) if (sel[v] == 1) val += w[v];
    std::memcpy(out_sel, sel.data(), n);
    *out_val = val;
    return rounds;
}

}  // extern "C"
