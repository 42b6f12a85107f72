// Transposition-table (DAG) MCTS oracle — quantifies the reference's
// `seen` dedup semantics against the pure tree the XLA engine uses.
//
// The reference's NodeStore keys every state in a concurrent hash map and
// redirects duplicate expansions to the canonical node
// (/root/reference/src/node.rs:135 `seen`, node.rs:272-326 upgrade/dedup,
// async_mcts.rs:293-299 "continue from canonical node") — statistics are
// per NODE, so transposed paths share visit information and the tree is a
// DAG. The JAX rebuild deliberately drops this (SURVEY.md §7 hard-parts
// (c); docs/PARITY.md): its trees are pure, stats live on parent edges.
// SURVEY §7(c) requires QUANTIFYING that trade. This oracle implements
// BOTH semantics sequentially (node-level statistics; `use_tt` toggles the
// dedup map) for Connect-Four and Othello, plus a head-to-head match
// driver, so the sims-quality delta is measured, not guessed:
//
//   * PUCT: Q(child) + cpuct * P[a] * sqrt(N_parent + 1e-6) / (1 + N_child)
//     (node.rs:352-356), Q from the child node's shared stats, Q=0 when
//     unvisited; first-index tie-break;
//   * uniform prior over valid moves, value 0 (the DumbConnectFourNnet
//     baseline, examples/connect_four.rs:12-43);
//   * negamax sign alternation on backup (intended semantics, fixes D5);
//     node W is stored from the parent-to-move perspective so Q(child)
//     reads directly — identical for every parent of a DAG node (the
//     canonical board fixes whose turn it is);
//   * dedup'd expansions link to the canonical node and CONTINUE the
//     descent through it (async_mcts.rs:293-299), consuming no node slot.
//
// With use_tt=0 this reduces to the pure tree and must reproduce
// mcts_oracle.cpp's edge-stats counts exactly (asserted in
// tests/test_native.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

constexpr float EPS = 1e-6f;  // node.rs:12

// ---------------------------------------------------------------------------
// xorshift64* RNG (match driver only; searches are deterministic)
// ---------------------------------------------------------------------------
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed ? seed : 0x9e3779b97f4a7c15ull) {}
  uint64_t next() {
    s ^= s >> 12;
    s ^= s << 25;
    s ^= s >> 27;
    return s * 0x2545f4914f6cdd1dull;
  }
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
};

// ---------------------------------------------------------------------------
// Games (canonical boards, +1 to move; step returns the negated next board)
// ---------------------------------------------------------------------------
struct Connect4 {
  static constexpr int CELLS = 42;
  static constexpr int ACTIONS = 7;
  static constexpr int MAX_MOVES = 42;
  static constexpr int ROWS = 6, COLS = 7;

  struct Board {
    int8_t c[CELLS];
    bool operator==(const Board& o) const {
      return std::memcmp(c, o.c, CELLS) == 0;
    }
  };

  static Board initial() {
    Board b{};
    std::memset(b.c, 0, CELLS);
    return b;
  }

  static int height(const Board& b, int col) {
    int h = 0;
    while (h < ROWS && b.c[h * COLS + col] != 0) ++h;
    return h;
  }

  static void valid_moves(const Board& b, bool* valid) {
    for (int a = 0; a < ACTIONS; ++a) valid[a] = height(b, a) < ROWS;
  }

  static Board step(const Board& b, int col) {
    Board n = b;
    int h = height(b, col);
    if (h >= ROWS) h = ROWS - 1;  // illegal drop degenerates (callers mask)
    n.c[h * COLS + col] = 1;
    for (int i = 0; i < CELLS; ++i) n.c[i] = -n.c[i];
    return n;
  }

  static bool has_win(const Board& b, int player) {
    auto at = [&](int r, int c) { return b.c[r * COLS + c]; };
    for (int r = 0; r < ROWS; ++r)
      for (int c = 0; c + 3 < COLS; ++c)
        if (at(r, c) == player && at(r, c + 1) == player &&
            at(r, c + 2) == player && at(r, c + 3) == player)
          return true;
    for (int r = 0; r + 3 < ROWS; ++r)
      for (int c = 0; c < COLS; ++c)
        if (at(r, c) == player && at(r + 1, c) == player &&
            at(r + 2, c) == player && at(r + 3, c) == player)
          return true;
    for (int r = 0; r + 3 < ROWS; ++r)
      for (int c = 0; c + 3 < COLS; ++c)
        if (at(r, c) == player && at(r + 1, c + 1) == player &&
            at(r + 2, c + 2) == player && at(r + 3, c + 3) == player)
          return true;
    for (int r = 3; r < ROWS; ++r)
      for (int c = 0; c + 3 < COLS; ++c)
        if (at(r, c) == player && at(r - 1, c + 1) == player &&
            at(r - 2, c + 2) == player && at(r - 3, c + 3) == player)
          return true;
    return false;
  }

  // (done, value from the player-to-move's perspective)
  static void terminal(const Board& b, bool* done, float* value) {
    bool lose = has_win(b, -1);
    bool win = has_win(b, 1);
    bool full = true;
    for (int a = 0; a < ACTIONS; ++a) full &= height(b, a) >= ROWS;
    *done = lose || win || full;
    *value = win ? 1.0f : (lose ? -1.0f : 0.0f);
  }

  static float heuristic(const Board&) { return 0.0f; }
};

struct Othello {
  static constexpr int CELLS = 64;
  static constexpr int ACTIONS = 65;  // 64 squares + pass
  static constexpr int MAX_MOVES = 96;
  static constexpr int N = 8;

  struct Board {
    int8_t c[CELLS];
    bool operator==(const Board& o) const {
      return std::memcmp(c, o.c, CELLS) == 0;
    }
  };

  static Board initial() {
    Board b{};
    std::memset(b.c, 0, CELLS);
    b.c[3 * N + 3] = 1;
    b.c[4 * N + 4] = 1;
    b.c[3 * N + 4] = -1;
    b.c[4 * N + 3] = -1;
    return b;
  }

  static constexpr int DR[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
  static constexpr int DC[8] = {-1, 0, 1, -1, 1, -1, 0, 1};

  // discs flipped by `player` placing at (r, c); 0 if not a capture
  static int flips_at(const Board& b, int player, int r, int c, bool apply,
                      Board* out) {
    if (b.c[r * N + c] != 0) return 0;
    int total = 0;
    for (int d = 0; d < 8; ++d) {
      int rr = r + DR[d], cc = c + DC[d], run = 0;
      while (rr >= 0 && rr < N && cc >= 0 && cc < N &&
             b.c[rr * N + cc] == -player) {
        ++run;
        rr += DR[d];
        cc += DC[d];
      }
      if (run > 0 && rr >= 0 && rr < N && cc >= 0 && cc < N &&
          b.c[rr * N + cc] == player) {
        total += run;
        if (apply) {
          int fr = r + DR[d], fc = c + DC[d];
          for (int k = 0; k < run; ++k) {
            out->c[fr * N + fc] = player;
            fr += DR[d];
            fc += DC[d];
          }
        }
      }
    }
    return total;
  }

  static bool can_place(const Board& b, int player) {
    for (int r = 0; r < N; ++r)
      for (int c = 0; c < N; ++c)
        if (flips_at(b, player, r, c, false, nullptr) > 0) return true;
    return false;
  }

  static void valid_moves(const Board& b, bool* valid) {
    bool any = false;
    for (int r = 0; r < N; ++r)
      for (int c = 0; c < N; ++c) {
        bool v = flips_at(b, 1, r, c, false, nullptr) > 0;
        valid[r * N + c] = v;
        any |= v;
      }
    valid[CELLS] = !any;  // pass legal only with no placement
  }

  static Board step(const Board& b, int action) {
    Board n = b;
    if (action < CELLS) {
      int r = action / N, c = action % N;
      flips_at(b, 1, r, c, true, &n);
      n.c[r * N + c] = 1;  // even an illegal drop places (callers mask)
    }
    for (int i = 0; i < CELLS; ++i) n.c[i] = -n.c[i];
    return n;
  }

  static void terminal(const Board& b, bool* done, float* value) {
    *done = !can_place(b, 1) && !can_place(b, -1);
    int diff = 0;
    for (int i = 0; i < CELLS; ++i) diff += b.c[i];
    *value = *done ? (diff > 0 ? 1.0f : (diff < 0 ? -1.0f : 0.0f)) : 0.0f;
  }

  static float heuristic(const Board& b) {
    int diff = 0;
    for (int i = 0; i < CELLS; ++i) diff += b.c[i];
    return static_cast<float>(diff) / static_cast<float>(CELLS);
  }
};

template <typename G>
struct BoardHash {
  size_t operator()(const typename G::Board& b) const {
    // FNV-1a over the cells
    uint64_t h = 1469598103934665603ull;
    for (int i = 0; i < G::CELLS; ++i) {
      h ^= static_cast<uint8_t>(b.c[i]);
      h *= 1099511628211ull;
    }
    return static_cast<size_t>(h);
  }
};

// ---------------------------------------------------------------------------
// Node-statistics PUCT search, optional transposition DAG
// ---------------------------------------------------------------------------
template <typename G>
struct Node {
  typename G::Board board;
  float p[G::ACTIONS];
  int child[G::ACTIONS];
  bool valid[G::ACTIONS];
  float n;     // node visit count (shared across DAG parents)
  float w;     // value sum, PARENT-to-move perspective
  bool term;
  float tval;
};

template <typename G>
struct Search {
  std::vector<Node<G>> nodes;
  std::unordered_map<typename G::Board, int, BoardHash<G>> seen;
  bool use_tt;
  float cpuct;
  int max_depth;
  long dedup_hits = 0;

  int make_node(const typename G::Board& b) {
    nodes.emplace_back();
    Node<G>& nd = nodes.back();
    nd.board = b;
    G::valid_moves(b, nd.valid);
    int nvalid = 0;
    for (int a = 0; a < G::ACTIONS; ++a) nvalid += nd.valid[a];
    for (int a = 0; a < G::ACTIONS; ++a) {
      nd.p[a] = nd.valid[a] ? 1.0f / static_cast<float>(nvalid) : 0.0f;
      nd.child[a] = -1;
    }
    nd.n = 0.0f;
    nd.w = 0.0f;
    G::terminal(b, &nd.term, &nd.tval);
    int idx = static_cast<int>(nodes.size()) - 1;
    if (use_tt) seen.emplace(b, idx);
    return idx;
  }

  void run(const typename G::Board& root, int num_sims, float* counts) {
    nodes.clear();
    seen.clear();
    nodes.reserve(num_sims + 1);
    make_node(root);
    std::vector<int> path(max_depth + 1);

    if (!nodes[0].term) {
      for (int sim = 0; sim < num_sims; ++sim) {
        int cur = 0, depth = 0;
        float v_leaf = 0.0f;
        while (true) {
          // PUCT over children's shared node stats (node.rs:343-370)
          Node<G>& nd = nodes[cur];
          float n_parent = 0.0f;
          for (int a = 0; a < G::ACTIONS; ++a)
            if (nd.valid[a] && nd.child[a] >= 0) n_parent += nodes[nd.child[a]].n;
          float sq = std::sqrt(n_parent + EPS);
          float best = -1e38f;
          int best_a = 0;
          for (int a = 0; a < G::ACTIONS; ++a) {
            if (!nd.valid[a]) continue;
            float nc = nd.child[a] >= 0 ? nodes[nd.child[a]].n : 0.0f;
            float q = nc > 0.0f ? nodes[nd.child[a]].w / nc : 0.0f;
            float s = q + cpuct * nd.p[a] * sq / (1.0f + nc);
            if (s > best) {
              best = s;
              best_a = a;
            }
          }
          int child = nodes[cur].child[best_a];
          if (child == -1) {
            typename G::Board nb = G::step(nodes[cur].board, best_a);
            if (use_tt) {
              auto it = seen.find(nb);
              if (it != seen.end()) {
                // dedup: link to the canonical node and CONTINUE the
                // descent through it (async_mcts.rs:293-299); no new slot
                nodes[cur].child[best_a] = it->second;
                ++dedup_hits;
                path[depth++] = it->second;
                if (nodes[it->second].term) {
                  v_leaf = nodes[it->second].tval;
                  break;
                }
                if (depth >= max_depth) {
                  v_leaf = G::heuristic(nodes[it->second].board);
                  break;
                }
                cur = it->second;
                continue;
              }
            }
            int idx = make_node(nb);
            nodes[cur].child[best_a] = idx;
            path[depth++] = idx;
            v_leaf = nodes[idx].term ? nodes[idx].tval : 0.0f;  // uniform net
            break;
          }
          path[depth++] = child;
          if (nodes[child].term) {
            v_leaf = nodes[child].tval;
            break;
          }
          if (depth >= max_depth) {
            v_leaf = G::heuristic(nodes[child].board);
            break;
          }
          cur = child;
        }
        // negamax backup onto the path nodes: node d sits (depth-1-d)
        // plies above the leaf; stored from the parent-to-move view
        // (one extra flip), matching the edge-stats engine exactly.
        for (int d = 0; d < depth; ++d) {
          float sign = ((depth - d) % 2 == 1) ? -1.0f : 1.0f;
          nodes[path[d]].n += 1.0f;
          nodes[path[d]].w += sign * v_leaf;
        }
      }
    }
    // root counts = child NODE visits (get_action_prob reads child visit
    // counts, async_mcts.rs:84-94)
    for (int a = 0; a < G::ACTIONS; ++a) {
      int c = nodes[0].child[a];
      counts[a] = c >= 0 ? nodes[c].n : 0.0f;
    }
  }
};

// ---------------------------------------------------------------------------
// Match driver: player A (use_tt_a) vs player B (use_tt_b)
// ---------------------------------------------------------------------------
template <typename G>
int play_game(bool tt_first, bool tt_second, int num_sims, float cpuct,
              int max_depth, int temp_moves, Rng& rng) {
  // returns +1 first-seat win, -1 second-seat win, 0 draw
  typename G::Board b = G::initial();
  bool done;
  float tval;
  G::terminal(b, &done, &tval);
  Search<G> s_first{{}, {}, tt_first, cpuct, max_depth};
  Search<G> s_second{{}, {}, tt_second, cpuct, max_depth};
  float counts[G::ACTIONS];
  int mover = 0;  // 0 = first seat
  for (int ply = 0; ply < G::MAX_MOVES && !done; ++ply) {
    Search<G>& s = mover == 0 ? s_first : s_second;
    s.run(b, num_sims, counts);
    int action = 0;
    if (ply < temp_moves) {
      float total = 0.0f;
      for (int a = 0; a < G::ACTIONS; ++a) total += counts[a];
      double x = rng.uniform() * total;
      double acc = 0.0;
      for (int a = 0; a < G::ACTIONS; ++a) {
        acc += counts[a];
        if (x <= acc && counts[a] > 0) {
          action = a;
          break;
        }
      }
    } else {
      float best = -1.0f;
      int ties = 0;
      for (int a = 0; a < G::ACTIONS; ++a) {
        if (counts[a] > best) {
          best = counts[a];
          ties = 1;
          action = a;
        } else if (counts[a] == best && best >= 0.0f) {
          ++ties;
          if (rng.uniform() < 1.0 / ties) action = a;
        }
      }
    }
    b = G::step(b, action);
    G::terminal(b, &done, &tval);
    if (done) {
      // tval is from the NEXT player's perspective; negative = mover won
      if (tval < -0.5f) return mover == 0 ? 1 : -1;
      if (tval > 0.5f) return mover == 0 ? -1 : 1;
      return 0;
    }
    mover ^= 1;
  }
  return 0;
}

template <typename G>
void match(int num_games, int num_sims, float cpuct, int max_depth,
           int temp_moves, uint64_t seed, int32_t* out) {
  // out: [a_wins, b_wins, draws]; half the games A sits first
  Rng rng(seed);
  out[0] = out[1] = out[2] = 0;
  for (int g = 0; g < num_games; ++g) {
    bool a_first = g < (num_games + 1) / 2;
    int r = a_first ? play_game<G>(true, false, num_sims, cpuct, max_depth,
                                   temp_moves, rng)
                    : play_game<G>(false, true, num_sims, cpuct, max_depth,
                                   temp_moves, rng);
    int a_score = a_first ? r : -r;
    if (a_score > 0)
      ++out[0];
    else if (a_score < 0)
      ++out[1];
    else
      ++out[2];
  }
}

}  // namespace

extern "C" {

// Node-stats search (use_tt toggles the reference's `seen` DAG dedup).
// game: 0 = connect-four (board int8[42]), 1 = othello (board int8[64]).
// Returns the dedup hit count; counts[] gets the root children's visits.
long az_tt_search(int game, const int8_t* board, int num_sims, float cpuct,
                  int max_depth, int use_tt, float* counts) {
  if (game == 0) {
    Connect4::Board b;
    std::memcpy(b.c, board, Connect4::CELLS);
    Search<Connect4> s{{}, {}, use_tt != 0, cpuct, max_depth};
    s.run(b, num_sims, counts);
    return s.dedup_hits;
  } else {
    Othello::Board b;
    std::memcpy(b.c, board, Othello::CELLS);
    Search<Othello> s{{}, {}, use_tt != 0, cpuct, max_depth};
    s.run(b, num_sims, counts);
    return s.dedup_hits;
  }
}

// Head-to-head: A = DAG/TT search, B = pure tree, equal sims. out[3].
void az_tt_match(int game, int num_games, int num_sims, float cpuct,
                 int max_depth, int temp_moves, uint64_t seed, int32_t* out) {
  if (game == 0)
    match<Connect4>(num_games, num_sims, cpuct, max_depth, temp_moves, seed,
                    out);
  else
    match<Othello>(num_games, num_sims, cpuct, max_depth, temp_moves, seed,
                   out);
}

}  // extern "C"
