// fa_runtime — native runtime core for the TPU serving path.
//
// The reference implements its runtime layer in C++ (pybind bindings, host
// wrappers, allocator-adjacent logic: kernel/fused_mha_api.cpp,
// kernel/*.cu host halves).  On TPU the kernel-launch half of that layer is
// replaced by XLA, but the *serving* runtime — KV page bookkeeping and the
// continuous-batching scheduler that the reference's stubbed `num_splits` /
// `block_table` machinery points at — is genuinely host-side and hot (it runs
// every decode step for every request), so it lives here in C++ with a C ABI
// consumed from Python via ctypes (no pybind11 in this environment).
//
// Two components:
//   * PagedAllocator — fixed pool of KV pages; per-sequence page lists;
//     O(1) alloc/free via a free list.  The page ids it hands out are the
//     rows of the device-side page pool; Python mirrors them into the
//     block_table argument of flash_attn_with_kvcache.  Optionally SHARDED
//     for the engine's seq-mesh mode: the block table's slot columns are
//     contiguously sharded over the "seq" mesh axis, so the page backing
//     slot j must live in the pool shard of the chip owning that column —
//     the allocator keeps one free list per shard and hands out SHARD-LOCAL
//     ids, which makes total KV capacity scale with the seq axis instead of
//     replicating the id space per chip.
//   * Scheduler — continuous batching: FIFO admission under page budget and
//     batch cap, per-step capacity reservation for running sequences, and
//     LIFO preemption (youngest first) back to the waiting queue when the
//     pool runs dry.
//
// Thread model: single-threaded per instance (the decode loop is one host
// thread); no locks.

#include <cstdint>
#include <cstring>
#include <deque>
#include <unordered_map>
#include <vector>

namespace {

struct PagedAllocator {
  int32_t page_size;
  int32_t num_shards;           // 1 = unsharded (classic behavior)
  int32_t slots_per_shard;      // block-table slots owned by each shard
  std::vector<std::vector<int32_t>> free_lists;  // per-shard stacks of local ids
  // shard-LOCAL ids in slot order; slot j's shard is j / slots_per_shard
  std::unordered_map<int64_t, std::vector<int32_t>> seq_pages;

  PagedAllocator(int32_t num_pages, int32_t ps, int32_t shards = 1,
                 int32_t sps = INT32_MAX)
      : page_size(ps), num_shards(shards), slots_per_shard(sps),
        free_lists(shards) {
    for (auto& fl : free_lists) {
      fl.reserve(num_pages);
      for (int32_t p = num_pages - 1; p >= 0; --p) fl.push_back(p);
    }
  }

  int32_t shard_of(int32_t slot) const {
    int32_t s = slot / slots_per_shard;
    return s < num_shards ? s : num_shards - 1;
  }

  int32_t num_free() const {
    int32_t t = 0;
    for (auto& fl : free_lists) t += (int32_t)fl.size();
    return t;
  }

  int32_t held(int64_t seq) const {
    auto it = seq_pages.find(seq);
    return it == seq_pages.end() ? 0 : (int32_t)it->second.size();
  }

  // Can slots [held, held+n) all be covered by their owning shards' pools?
  bool can_extend(int64_t seq, int32_t n) const {
    int32_t base = held(seq);
    // per-shard demand over the contiguous slot range
    for (int32_t s = shard_of(base); s <= shard_of(base + n - 1); ++s) {
      int32_t lo = s * slots_per_shard;
      int32_t hi = lo + slots_per_shard;
      if (base > lo) lo = base;
      if (base + n < hi) hi = base + n;
      if (hi > lo && (int32_t)free_lists[s].size() < hi - lo) return false;
    }
    return true;
  }

  // Append n pages to seq's list. All-or-nothing. Returns n on success, 0 if
  // the pool (any owning shard) can't cover it.
  int32_t extend(int64_t seq, int32_t n, int32_t* out) {
    if (!can_extend(seq, n)) return 0;
    auto& pages = seq_pages[seq];
    for (int32_t i = 0; i < n; ++i) {
      auto& fl = free_lists[shard_of((int32_t)pages.size())];
      int32_t p = fl.back();
      fl.pop_back();
      pages.push_back(p);
      if (out) out[i] = p;
    }
    return n;
  }

  int32_t pages_of(int64_t seq, int32_t* out, int32_t cap) const {
    auto it = seq_pages.find(seq);
    if (it == seq_pages.end()) return 0;
    int32_t n = (int32_t)it->second.size();
    if (out) {
      int32_t c = n < cap ? n : cap;
      std::memcpy(out, it->second.data(), c * sizeof(int32_t));
    }
    return n;
  }

  void release(int64_t seq) {
    auto it = seq_pages.find(seq);
    if (it == seq_pages.end()) return;
    for (size_t j = 0; j < it->second.size(); ++j)
      free_lists[shard_of((int32_t)j)].push_back(it->second[j]);
    seq_pages.erase(it);
  }
};

enum class State : int32_t { WAITING = 0, RUNNING = 1, FINISHED = 2 };

struct Request {
  int64_t id;
  int32_t prompt_len;
  int32_t max_new_tokens;
  int32_t generated = 0;
  State state = State::WAITING;
  bool needs_prefill = true;
  int64_t arrival;              // monotonic admission-order tiebreak

  int32_t cur_len() const { return prompt_len + generated; }
};

struct Scheduler {
  PagedAllocator alloc;
  int32_t max_batch;
  int64_t clock = 0;
  int64_t preemptions = 0;
  std::deque<int64_t> waiting;                 // FIFO of request ids
  std::vector<int64_t> running;                // admission order (oldest first)
  std::unordered_map<int64_t, Request> reqs;

  Scheduler(int32_t max_batch_, int32_t num_pages, int32_t page_size,
            int32_t shards = 1, int32_t slots_per_shard = INT32_MAX)
      : alloc(num_pages, page_size, shards, slots_per_shard),
        max_batch(max_batch_) {}

  int32_t pages_for_len(int32_t len) const {
    return (len + alloc.page_size - 1) / alloc.page_size;
  }

  bool add(int64_t id, int32_t prompt_len, int32_t max_new_tokens) {
    if (reqs.count(id) || prompt_len <= 0 || max_new_tokens <= 0) return false;
    Request r;
    r.id = id;
    r.prompt_len = prompt_len;
    r.max_new_tokens = max_new_tokens;
    r.arrival = clock++;
    reqs.emplace(id, r);
    waiting.push_back(id);
    return true;
  }

  void preempt_youngest() {
    // LIFO preemption: the youngest running request gives back its pages and
    // returns to the FRONT of the waiting queue (it stays next in line).
    int64_t id = running.back();
    running.pop_back();
    Request& r = reqs[id];
    alloc.release(id);
    r.state = State::WAITING;
    // generated tokens are KEPT: they were already emitted to the caller.
    // The re-prefill recomputes KV for prompt+generated in one pass.
    r.needs_prefill = true;
    waiting.push_front(id);
    ++preemptions;
  }

  // One scheduling step. Guarantees every returned running sequence has page
  // capacity for cur_len()+1 tokens (prefill requests: prompt_len+1).
  // Fills `ids` (cap `cap`) with the running set, `prefill_mask` parallel
  // to it. Returns count (or -1 if cap too small).
  int32_t step(int64_t* ids, int8_t* prefill_mask, int32_t cap) {
    // 1. reserve +1-token capacity for already-running seqs, oldest first;
    //    preempt youngest (never the one being reserved) on pressure.
    for (size_t i = 0; i < running.size(); ++i) {
      Request& r = reqs[running[i]];
      int32_t held = alloc.pages_of(r.id, nullptr, 0);
      int32_t need = pages_for_len(r.cur_len() + 1) - held;
      while (need > 0 && !alloc.can_extend(r.id, need) &&
             running.size() > i + 1) {
        preempt_youngest();
      }
      if (need > 0 && alloc.extend(r.id, need, nullptr) == 0) {
        // pool exhausted even after preempting everything younger: this
        // request itself must wait.  (Can only happen for the oldest when
        // the pool is smaller than one sequence.)
        alloc.release(r.id);
        r.state = State::WAITING;
        r.needs_prefill = true;
        waiting.push_front(r.id);
        running.erase(running.begin() + i);
        --i;
        ++preemptions;
      }
    }
    // 2. FIFO admission while batch slots + pages allow.
    while (!waiting.empty() && (int32_t)running.size() < max_batch) {
      int64_t id = waiting.front();
      Request& r = reqs[id];
      int32_t need = pages_for_len(r.cur_len() + 1);
      if (!alloc.can_extend(id, need)) break;  // head-of-line: keep FIFO order
      alloc.extend(id, need, nullptr);
      waiting.pop_front();
      r.state = State::RUNNING;
      r.needs_prefill = true;
      running.push_back(id);
    }
    // 3. emit
    if ((int32_t)running.size() > cap) return -1;
    for (size_t i = 0; i < running.size(); ++i) {
      ids[i] = running[i];
      prefill_mask[i] = reqs[running[i]].needs_prefill ? 1 : 0;
    }
    return (int32_t)running.size();
  }

  // Record one generated token; marks prefill done. Returns 1 if the request
  // just finished (caller should then call finish()).
  int32_t advance(int64_t id) {
    auto it = reqs.find(id);
    if (it == reqs.end() || it->second.state != State::RUNNING) return -1;
    Request& r = it->second;
    r.needs_prefill = false;
    r.generated += 1;
    return r.generated >= r.max_new_tokens ? 1 : 0;
  }

  bool finish(int64_t id) {
    auto it = reqs.find(id);
    if (it == reqs.end()) return false;
    alloc.release(id);
    it->second.state = State::FINISHED;
    for (size_t i = 0; i < running.size(); ++i)
      if (running[i] == id) { running.erase(running.begin() + i); break; }
    return true;
  }
};

}  // namespace

extern "C" {

// ---- PagedAllocator C ABI ----
// Sharded form: `num_pages` is PER SHARD; `slots_per_shard` maps block-table
// slot columns to shards (contiguous).  The classic creators are shards=1.
void* fa_alloc_create_sharded(int32_t num_pages, int32_t page_size,
                              int32_t shards, int32_t slots_per_shard) {
  if (num_pages <= 0 || page_size <= 0 || shards <= 0 || slots_per_shard <= 0)
    return nullptr;
  return new PagedAllocator(num_pages, page_size, shards, slots_per_shard);
}
void* fa_alloc_create(int32_t num_pages, int32_t page_size) {
  return fa_alloc_create_sharded(num_pages, page_size, 1, INT32_MAX);
}
int32_t fa_alloc_can_extend(void* a, int64_t seq, int32_t n) {
  return ((PagedAllocator*)a)->can_extend(seq, n) ? 1 : 0;
}
void fa_alloc_destroy(void* a) { delete (PagedAllocator*)a; }
int32_t fa_alloc_num_free(void* a) { return ((PagedAllocator*)a)->num_free(); }
int32_t fa_alloc_extend(void* a, int64_t seq, int32_t n, int32_t* out) {
  return ((PagedAllocator*)a)->extend(seq, n, out);
}
int32_t fa_alloc_pages_of(void* a, int64_t seq, int32_t* out, int32_t cap) {
  return ((PagedAllocator*)a)->pages_of(seq, out, cap);
}
void fa_alloc_release(void* a, int64_t seq) { ((PagedAllocator*)a)->release(seq); }

// ---- Scheduler C ABI ----
void* fa_sched_create_sharded(int32_t max_batch, int32_t num_pages,
                              int32_t page_size, int32_t shards,
                              int32_t slots_per_shard) {
  if (max_batch <= 0 || num_pages <= 0 || page_size <= 0 || shards <= 0 ||
      slots_per_shard <= 0)
    return nullptr;
  return new Scheduler(max_batch, num_pages, page_size, shards,
                       slots_per_shard);
}
void* fa_sched_create(int32_t max_batch, int32_t num_pages, int32_t page_size) {
  return fa_sched_create_sharded(max_batch, num_pages, page_size, 1,
                                 INT32_MAX);
}
void fa_sched_destroy(void* s) { delete (Scheduler*)s; }
int32_t fa_sched_add(void* s, int64_t id, int32_t prompt_len, int32_t max_new) {
  return ((Scheduler*)s)->add(id, prompt_len, max_new) ? 1 : 0;
}
int32_t fa_sched_step(void* s, int64_t* ids, int8_t* prefill, int32_t cap) {
  return ((Scheduler*)s)->step(ids, prefill, cap);
}
int32_t fa_sched_advance(void* s, int64_t id) { return ((Scheduler*)s)->advance(id); }
int32_t fa_sched_finish(void* s, int64_t id) {
  return ((Scheduler*)s)->finish(id) ? 1 : 0;
}
int32_t fa_sched_pages_of(void* s, int64_t id, int32_t* out, int32_t cap) {
  return ((Scheduler*)s)->alloc.pages_of(id, out, cap);
}
int32_t fa_sched_num_free_pages(void* s) { return ((Scheduler*)s)->alloc.num_free(); }
int32_t fa_sched_num_waiting(void* s) { return (int32_t)((Scheduler*)s)->waiting.size(); }
int32_t fa_sched_num_running(void* s) { return (int32_t)((Scheduler*)s)->running.size(); }
int64_t fa_sched_num_preemptions(void* s) { return ((Scheduler*)s)->preemptions; }

}  // extern "C"
