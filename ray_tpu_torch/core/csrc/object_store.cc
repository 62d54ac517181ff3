// Shared-memory object store: the plasma equivalent for the TPU runtime.
//
// Design parity with the reference's plasma store
// (reference src/ray/object_manager/plasma/{store.h,object_lifecycle_manager.h,
// eviction_policy.h,plasma_allocator.cc}) re-thought for this runtime's
// process model: the store library lives inside the raylet process, which
// owns a large mmap'd file in /dev/shm.  Worker processes mmap the same
// file read-only (or read-write while producing) and receive {offset,size}
// leases from the raylet over its socket.  All metadata (object table,
// free list, LRU queue, pin counts) therefore lives in ordinary process
// memory here — no in-shm metadata, no lock-free tricks needed, and the
// data plane stays zero-copy.
//
// Concurrency: the metadata table is SHARDED.  Objects hash (by id) onto
// one of ``num_shards`` lock-striped shards, each holding its own mutex,
// object map and LRU list, so N concurrent writers doing
// Create/Seal/Get/Release/Delete serialize only when their ids collide
// on a shard — the single global metadata mutex this replaces made the
// multi-client put path anti-scale (76 Gbps single client vs 18
// multi).  Global ordering (eviction, spill candidates) comes
// from one atomic LRU clock: every touch stamps the entry, and
// cross-shard sweeps merge per-shard queues by stamp.  Cross-shard
// operations (StatsEx, eviction scans, candidate queries, bucket
// reclaim) take locks strictly one at a time — shard and allocator
// locks are NEVER nested with each other in any order except
// shard -> allocator (a free returning its block), so no lock-order
// cycle exists.
//
// Allocation: per-client slab buckets over a STRIPED offset-partitioned
// global free list.  Each client (keyed by an allocation *hint* the
// raylet derives from the producing connection) owns a bucket of free
// blocks carved from the arena in large slabs; blocks freed by a delete
// return to the bucket that allocated them, so a client's next
// allocation lands on offsets its process has already faulted in.  This
// is the multi-client put fix for fault-expensive hosts (gVisor-class
// virtualized hosts fault at ~0.3 GB/s vs ~5 GB/s warm).  The global list
// behind the buckets is itself striped: the arena's offset space is
// partitioned into equal regions, each with its own mutex + free list,
// so concurrent slab carves and large (>slab) allocations no longer
// serialize on one allocator mutex.  A block always frees back into the
// stripe(s) its offsets fall in (split at region boundaries), keeping
// coalescing local to a stripe.  Allocations that no single stripe can
// satisfy fall back to a whole-arena pass that takes every stripe lock
// in ascending index order (deterministic, deadlock-free) and can carve
// runs spanning region boundaries.
// First-fit with coalescing within each list; 64-byte alignment so
// numpy/XLA host buffers are aligned.
//
// Eviction: LRU over sealed, unpinned objects (reference
// eviction_policy.h:160), triggered on allocation failure and by an
// explicit spill-candidate query so the raylet can spill before the
// store is hard-full.  SpillCandidates additionally surfaces sealed
// objects whose only pins are the raylet's own (pin_count <= max_pins),
// ordered by last-pin stamp — the raylet's LRU-by-last-pin spill queue.
// When the global stripes cannot carve a new slab, free blocks hoarded
// in buckets are reclaimed into the stripes first.
//
// Contention telemetry: every shard / bucket / stripe mutex is acquired
// through a try_lock-first helper that counts failed fast acquisitions,
// surfaced via StatsEx — the health signal that says whether the
// striping actually relieved the metadata plane.
//
// C ABI only (loaded via ctypes): every function is `extern "C"`, handles
// are opaque pointers, ids are fixed 28-byte blobs.

#include <algorithm>
#include <array>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <list>
#include <map>
#include <mutex>
#include <string>
#include <tuple>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kAlign = 64;
constexpr size_t kIdSize = 28;
// Slab granularity for per-client buckets (shrunk for small arenas so
// buckets still engage); allocations larger than a slab go to the
// global stripes directly.
constexpr uint64_t kSlabSize = 128ull * 1024 * 1024;
constexpr uint64_t kNumBuckets = 64;   // hints fold into this many buckets
constexpr uint64_t kMaxShards = 64;    // metadata shards (runtime <= this)
constexpr uint64_t kDefaultShards = 16;
constexpr uint64_t kMaxStripes = 16;   // global free-list stripes

inline uint64_t AlignUp(uint64_t n) { return (n + kAlign - 1) / kAlign * kAlign; }

struct IdKey {
  unsigned char b[kIdSize];
  bool operator==(const IdKey& o) const { return std::memcmp(b, o.b, kIdSize) == 0; }
};

struct IdHash {
  size_t operator()(const IdKey& k) const {
    // ids contain fresh entropy in their tail; fold 8 tail bytes.
    uint64_t h;
    std::memcpy(&h, k.b + kIdSize - 8, 8);
    return static_cast<size_t>(h * 0x9E3779B97F4A7C15ull);
  }
};

enum class ObjectState : uint8_t { kCreated, kSealed };

struct Entry {
  uint64_t offset = 0;
  uint64_t size = 0;          // payload size requested by the client
  uint64_t alloc_size = 0;    // aligned size actually reserved (0 while
                              // allocation is still in flight)
  uint32_t bucket = 0;        // owning bucket when !global_owner
  bool global_owner = false;  // block came from the global stripes directly
  bool doomed = false;        // Delete() arrived while pinned: free on
                              // the last Release (plasma parity — a
                              // freed-but-still-read object must not
                              // strand its block, else churny put/free
                              // workloads walk the arena through
                              // ever-colder offsets)
  ObjectState state = ObjectState::kCreated;
  int64_t pin_count = 0;      // outstanding get leases (evict only at 0)
  uint64_t seq = 0;           // LRU clock value at last touch/pin
  uint64_t token = 0;         // creation token: a Create only commits
                              // into the placeholder IT reserved (a
                              // Delete+reCreate of the id mid-alloc
                              // must not adopt the stale allocation)
  std::list<IdKey>::iterator lru_it;
  bool in_lru = false;
};

// Offset-ordered free list with coalescing insert (shared by the global
// stripes and every bucket).
using FreeList = std::map<uint64_t, uint64_t>;  // offset -> length

void CoalescingInsert(FreeList& fl, uint64_t off, uint64_t len) {
  if (len == 0) return;
  auto next = fl.lower_bound(off);
  if (next != fl.begin()) {
    auto prev = std::prev(next);
    if (prev->first + prev->second == off) {
      off = prev->first;
      len += prev->second;
      fl.erase(prev);
    }
  }
  if (next != fl.end() && off + len == next->first) {
    len += next->second;
    fl.erase(next);
  }
  fl.emplace(off, len);
}

int64_t FirstFit(FreeList& fl, uint64_t need) {
  for (auto it = fl.begin(); it != fl.end(); ++it) {
    if (it->second >= need) {
      uint64_t off = it->first;
      uint64_t remaining = it->second - need;
      fl.erase(it);
      if (remaining > 0) fl.emplace(off + need, remaining);
      return static_cast<int64_t>(off);
    }
  }
  return -1;
}

// try_lock-first acquisition that counts contended (slow-path) locks.
// The count is the striping health signal StatsEx surfaces.
class ContendedLock {
 public:
  ContendedLock(std::mutex& mu, std::atomic<uint64_t>& counter)
      : lock_(mu, std::try_to_lock) {
    if (!lock_.owns_lock()) {
      counter.fetch_add(1, std::memory_order_relaxed);
      lock_.lock();
    }
  }

 private:
  std::unique_lock<std::mutex> lock_;
};

class Store {
 public:
  Store(void* base, uint64_t capacity, int fd, std::string path,
        uint64_t num_shards)
      : base_(static_cast<unsigned char*>(base)),
        capacity_(capacity),
        slab_(std::min(kSlabSize,
                       std::max(kAlign, AlignUp(capacity / kNumBuckets)))),
        fd_(fd),
        path_(std::move(path)) {
    num_shards_ = num_shards == 0 ? kDefaultShards
                                  : std::min(num_shards, kMaxShards);
    // Stripe the global free list only when regions stay slab-sized:
    // each stripe must be able to carve whole slabs or the striping
    // just manufactures fragmentation on small arenas.
    num_stripes_ = std::min<uint64_t>(
        std::max<uint64_t>(capacity / (4 * slab_), 1), kMaxStripes);
    stripe_size_ = AlignUp(capacity / num_stripes_);
    for (uint64_t i = 0; i < num_stripes_; ++i) {
      uint64_t start = i * stripe_size_;
      if (start >= capacity) {
        num_stripes_ = i;
        break;
      }
      uint64_t end = std::min(start + stripe_size_, capacity);
      stripes_[i].free.emplace(start, end - start);
    }
  }

  ~Store() {
    munmap(base_, capacity_);
    close(fd_);
  }

  // Returns payload offset, or -1 if full even after eviction, or -2 if
  // the id already exists.  ``hint`` keys the allocation bucket: objects
  // created by the same client reuse blocks that client freed before,
  // keeping its page-table entries warm (see file header).
  int64_t Create(const IdKey& id, uint64_t size, uint64_t hint) {
    uint64_t need = AlignUp(std::max<uint64_t>(size, 1));
    uint32_t b = static_cast<uint32_t>(hint % kNumBuckets);
    Shard& sh = ShardFor(id);
    uint64_t token = create_token_.fetch_add(1, std::memory_order_relaxed) + 1;
    {
      // reserve the id first so a racing create of the same id fails
      // fast instead of double-allocating
      ContendedLock g(sh.mu, sh.contention);
      if (sh.table.count(id)) return -2;
      Entry placeholder;
      placeholder.token = token;
      sh.table.emplace(id, std::move(placeholder));
    }
    bool global_owner = false;
    int64_t off = TryAlloc(need, b, &global_owner);
    if (off < 0) {
      ReclaimBuckets();
      off = TryAlloc(need, b, &global_owner);
    }
    // Evict-then-allocate is not atomic (eviction runs shard by shard,
    // the allocators under their own locks), so a concurrent Create can
    // steal the freed space — retry a few rounds before giving up.
    for (int attempt = 0; attempt < 3 && off < 0; ++attempt) {
      uint64_t freed = EvictSome(need);
      ReclaimBuckets();
      off = TryAlloc(need, b, &global_owner);
      if (off < 0 && freed == 0) break;  // nothing left to evict
    }
    ContendedLock g(sh.mu, sh.contention);
    auto it = sh.table.find(id);
    if (it == sh.table.end() || it->second.token != token) {
      // OUR placeholder was deleted while we allocated (caller bug, but
      // must not leak the block).  The token check matters: a racing
      // Delete + re-Create of the same id may have installed a FRESH
      // placeholder at this key — committing into it would double-fill
      // the entry and leak whichever block loses the race.
      if (off >= 0) ReturnBlock(static_cast<uint64_t>(off), need, b,
                                global_owner);
      return -1;
    }
    if (off < 0) {
      sh.table.erase(it);
      return -1;
    }
    Entry& e = it->second;
    if (e.in_lru) {  // defensive: a racing Seal/Touch on the placeholder
      sh.lru.erase(e.lru_it);
      e.in_lru = false;
    }
    e.offset = static_cast<uint64_t>(off);
    e.size = size;
    e.alloc_size = need;
    e.bucket = b;
    e.global_owner = global_owner;
    e.state = ObjectState::kCreated;
    used_.fetch_add(need, std::memory_order_relaxed);
    if (!global_owner)
      bucket_used_[b].fetch_add(need, std::memory_order_relaxed);
    return off;
  }

  bool Seal(const IdKey& id) {
    Shard& sh = ShardFor(id);
    ContendedLock g(sh.mu, sh.contention);
    auto it = sh.table.find(id);
    if (it == sh.table.end() || it->second.state == ObjectState::kSealed ||
        it->second.alloc_size == 0) {
      // alloc_size == 0: a placeholder whose Create is still
      // allocating — sealing it would put a zero-sized entry in the
      // LRU and let eviction free the block mid-commit
      return false;
    }
    it->second.state = ObjectState::kSealed;
    TouchLocked(sh, id, it->second);
    return true;
  }

  // Pins the object (caller must Release). Returns false if absent/unsealed.
  // A pin stamps the LRU clock: the spill queue orders by LAST PIN, so
  // actively-read objects stay hot even while they never hit zero pins.
  bool Get(const IdKey& id, uint64_t* offset, uint64_t* size) {
    Shard& sh = ShardFor(id);
    ContendedLock g(sh.mu, sh.contention);
    auto it = sh.table.find(id);
    if (it == sh.table.end() || it->second.state != ObjectState::kSealed ||
        it->second.doomed) {
      return false;
    }
    it->second.pin_count++;
    it->second.seq = clock_.fetch_add(1, std::memory_order_relaxed) + 1;
    if (it->second.in_lru) {  // pinned objects leave the eviction queue
      sh.lru.erase(it->second.lru_it);
      it->second.in_lru = false;
    }
    *offset = it->second.offset;
    *size = it->second.size;
    return true;
  }

  bool Release(const IdKey& id) {
    Shard& sh = ShardFor(id);
    ContendedLock g(sh.mu, sh.contention);
    auto it = sh.table.find(id);
    if (it == sh.table.end() || it->second.pin_count <= 0) return false;
    if (--it->second.pin_count == 0) {
      if (it->second.doomed) {
        FreeEntryLocked(sh, it);  // deferred Delete lands now
      } else {
        TouchLocked(sh, id, it->second);
      }
    }
    return true;
  }

  bool Contains(const IdKey& id) {
    Shard& sh = ShardFor(id);
    ContendedLock g(sh.mu, sh.contention);
    auto it = sh.table.find(id);
    return it != sh.table.end() &&
           it->second.state == ObjectState::kSealed && !it->second.doomed;
  }

  // Abort an unsealed create or delete a sealed object.  A pinned
  // object is doomed instead: invisible to new Gets, freed when the
  // last outstanding lease releases.
  bool Delete(const IdKey& id) {
    Shard& sh = ShardFor(id);
    ContendedLock g(sh.mu, sh.contention);
    auto it = sh.table.find(id);
    if (it == sh.table.end()) return false;
    if (it->second.pin_count > 0) {
      if (!it->second.doomed) {
        it->second.doomed = true;
        doomed_current_.fetch_add(1, std::memory_order_relaxed);
        doomed_total_.fetch_add(1, std::memory_order_relaxed);
      }
      return false;
    }
    FreeEntryLocked(sh, it);
    return true;
  }

  uint64_t Evict(uint64_t bytes_needed) { return EvictSome(bytes_needed); }

  // Oldest sealed unpinned objects — the raylet's eviction candidates.
  // Per-shard LRU queues are merged by clock stamp (exact global LRU
  // order).  Writes up to max ids into out (28 bytes each); returns count.
  uint64_t LruCandidates(unsigned char* out, uint64_t max_ids) {
    std::vector<std::pair<uint64_t, IdKey>> cands;  // (seq, id)
    for (uint64_t s = 0; s < num_shards_; ++s) {
      Shard& sh = shards_[s];
      ContendedLock g(sh.mu, sh.contention);
      uint64_t taken = 0;
      for (auto it = sh.lru.begin();
           it != sh.lru.end() && taken < max_ids; ++it, ++taken) {
        auto ent = sh.table.find(*it);
        cands.emplace_back(ent->second.seq, *it);
      }
    }
    std::sort(cands.begin(), cands.end(),
              [](const auto& a, const auto& b) { return a.first < b.first; });
    uint64_t n = std::min<uint64_t>(cands.size(), max_ids);
    for (uint64_t i = 0; i < n; ++i) {
      std::memcpy(out + i * kIdSize, cands[i].second.b, kIdSize);
    }
    return n;
  }

  // Sealed, non-doomed objects with pin_count <= max_pins, oldest last
  // pin first — the raylet's spill queue (its own primary pin keeps
  // pin_count at 1, so max_pins=1 means "no client is reading this").
  // Unsealed and client-pinned objects never appear.  Fills ids (28B
  // each) and sizes in parallel; returns the count written.
  uint64_t SpillCandidates(unsigned char* out_ids, uint64_t* out_sizes,
                           uint64_t max_ids, uint64_t max_pins) {
    std::vector<std::tuple<uint64_t, IdKey, uint64_t>> cands;
    for (uint64_t s = 0; s < num_shards_; ++s) {
      Shard& sh = shards_[s];
      ContendedLock g(sh.mu, sh.contention);
      for (auto& kv : sh.table) {
        const Entry& e = kv.second;
        if (e.state == ObjectState::kSealed && !e.doomed &&
            e.alloc_size > 0 &&
            e.pin_count <= static_cast<int64_t>(max_pins)) {
          cands.emplace_back(e.seq, kv.first, e.size);
        }
      }
    }
    std::sort(cands.begin(), cands.end(),
              [](const auto& a, const auto& b) {
                return std::get<0>(a) < std::get<0>(b);
              });
    uint64_t n = std::min<uint64_t>(cands.size(), max_ids);
    for (uint64_t i = 0; i < n; ++i) {
      std::memcpy(out_ids + i * kIdSize, std::get<1>(cands[i]).b, kIdSize);
      out_sizes[i] = std::get<2>(cands[i]);
    }
    return n;
  }

  // Lock-free occupancy probe for the raylet's per-allocation spill
  // pressure check: used_ is an atomic and capacity_ a constant, so
  // the hot put path never sweeps the shard mutexes (Stats() does, to
  // count objects — and its ContendedLock sweeps would inflate the
  // very contention counters that measure striping health).
  uint64_t Used() const { return used_.load(std::memory_order_relaxed); }

  void Stats(uint64_t* used, uint64_t* capacity, uint64_t* num_objects) {
    *used = used_.load(std::memory_order_relaxed);
    *capacity = capacity_;
    uint64_t n = 0;
    for (uint64_t s = 0; s < num_shards_; ++s) {
      Shard& sh = shards_[s];
      ContendedLock g(sh.mu, sh.contention);
      n += sh.table.size();
    }
    *num_objects = n;
  }

  // Extended stats for the telemetry plane.  Fills up to ``max`` values
  // of: [used, capacity, num_objects, doomed_current, doomed_total,
  // reuse_hits, reuse_misses, active_buckets, bucket_free_bytes,
  // metadata_shards, shard_contention, alloc_contention, alloc_stripes];
  // returns the count written.  Locks are only ever taken one at a time
  // (shard sweep, then bucket sweep — never nested).
  uint64_t StatsEx(uint64_t* out, uint64_t max) {
    uint64_t vals[13] = {0};
    uint64_t num_objects = 0, shard_cont = 0;
    for (uint64_t s = 0; s < num_shards_; ++s) {
      Shard& sh = shards_[s];
      // read the counter BEFORE locking so this sweep's own slow-path
      // acquisitions don't count themselves
      shard_cont += sh.contention.load(std::memory_order_relaxed);
      ContendedLock g(sh.mu, sh.contention);
      num_objects += sh.table.size();
    }
    vals[0] = used_.load(std::memory_order_relaxed);
    vals[1] = capacity_;
    vals[2] = num_objects;
    vals[3] = doomed_current_.load(std::memory_order_relaxed);
    vals[4] = doomed_total_.load(std::memory_order_relaxed);
    for (uint64_t b = 0; b < kNumBuckets; ++b)
      if (bucket_used_[b].load(std::memory_order_relaxed) > 0) ++vals[7];
    uint64_t hits = 0, misses = global_misses_.load(
        std::memory_order_relaxed);
    uint64_t bucket_free = 0, alloc_cont = 0;
    for (auto& bucket : buckets_) {
      hits += bucket.hits.load(std::memory_order_relaxed);
      misses += bucket.misses.load(std::memory_order_relaxed);
      alloc_cont += bucket.contention.load(std::memory_order_relaxed);
      ContendedLock g(bucket.mu, bucket.contention);
      for (auto& kv : bucket.free) bucket_free += kv.second;
    }
    for (uint64_t i = 0; i < num_stripes_; ++i)
      alloc_cont += stripes_[i].contention.load(std::memory_order_relaxed);
    vals[5] = hits;
    vals[6] = misses;
    vals[8] = bucket_free;
    vals[9] = num_shards_;
    vals[10] = shard_cont;
    vals[11] = alloc_cont;
    vals[12] = num_stripes_;
    uint64_t n = std::min<uint64_t>(max, 13);
    for (uint64_t i = 0; i < n; ++i) out[i] = vals[i];
    return n;
  }

  // Per-bucket live allocation bytes (arena occupancy by client bucket);
  // fills up to ``max`` entries, returns the count written.
  uint64_t BucketUsed(uint64_t* out, uint64_t max) {
    uint64_t n = std::min<uint64_t>(max, kNumBuckets);
    for (uint64_t b = 0; b < n; ++b)
      out[b] = bucket_used_[b].load(std::memory_order_relaxed);
    return n;
  }

  // Per-shard contended-lock counts (cumulative); returns entries written.
  uint64_t ShardContention(uint64_t* out, uint64_t max) {
    uint64_t n = std::min<uint64_t>(max, num_shards_);
    for (uint64_t s = 0; s < n; ++s)
      out[s] = shards_[s].contention.load(std::memory_order_relaxed);
    return n;
  }

  const std::string& path() const { return path_; }

 private:
  struct Shard {
    std::mutex mu;
    std::unordered_map<IdKey, Entry, IdHash> table;
    std::list<IdKey> lru;  // front = oldest evictable in this shard
    std::atomic<uint64_t> contention{0};  // slow-path lock acquisitions
  };

  struct Bucket {
    std::mutex mu;
    FreeList free;
    // reuse telemetry (relaxed atomics: monotonic counters, read racily
    // by StatsEx — exact ordering is irrelevant)
    std::atomic<uint64_t> hits{0};
    std::atomic<uint64_t> misses{0};
    std::atomic<uint64_t> contention{0};
  };

  struct Stripe {
    std::mutex mu;
    FreeList free;  // blocks whose offsets fall in this stripe's region
    std::atomic<uint64_t> contention{0};
  };

  Shard& ShardFor(const IdKey& id) {
    return shards_[IdHash()(id) % num_shards_];
  }

  // ---- allocation (lock order: shard -> {stripe | bucket}; the
  // allocator locks are never taken together except in the ordered
  // all-stripes slow path, and never before a shard lock) ----

  // One allocation pass: the client's bucket first (small allocations),
  // then a fresh slab carved from the global stripes, then the stripes
  // directly.  No metadata lock held.  Reuse telemetry: an allocation
  // served from the bucket's existing free list is a *hit* (the client
  // writes through page-table-warm offsets); a slab carve or global
  // allocation is a *miss* (cold pages) — the hit rate is the health
  // signal for the per-client warmth machinery.
  int64_t TryAlloc(uint64_t need, uint32_t b, bool* global_owner) {
    if (need <= slab_) {
      *global_owner = false;
      {
        ContendedLock g(buckets_[b].mu, buckets_[b].contention);
        int64_t off = FirstFit(buckets_[b].free, need);
        if (off >= 0) {
          buckets_[b].hits.fetch_add(1, std::memory_order_relaxed);
          return off;
        }
      }
      uint64_t carve = std::max(slab_, need);
      int64_t slab = AllocGlobal(carve, b);
      if (slab >= 0) {
        ContendedLock g(buckets_[b].mu, buckets_[b].contention);
        buckets_[b].misses.fetch_add(1, std::memory_order_relaxed);
        CoalescingInsert(buckets_[b].free,
                         static_cast<uint64_t>(slab) + need, carve - need);
        return slab;
      }
    }
    *global_owner = true;
    global_misses_.fetch_add(1, std::memory_order_relaxed);
    return AllocGlobal(need, b);
  }

  // Striped global allocation: probe the hint's home stripe first, then
  // the others, each under its own lock.  When no single stripe fits
  // (fragmentation, or the request is larger than a region), fall back
  // to a whole-arena pass holding every stripe lock in ascending order
  // that can carve runs spanning region boundaries.
  int64_t AllocGlobal(uint64_t need, uint64_t hint) {
    for (uint64_t j = 0; j < num_stripes_; ++j) {
      uint64_t i = (hint + j) % num_stripes_;
      ContendedLock g(stripes_[i].mu, stripes_[i].contention);
      int64_t off = FirstFit(stripes_[i].free, need);
      if (off >= 0) return off;
    }
    if (num_stripes_ == 1) return -1;
    return AllocAcrossStripes(need);
  }

  // Whole-arena first fit allowing cross-boundary runs.  Takes every
  // stripe lock in index order (deterministic — this is the only place
  // two allocator locks are ever held together).  Blocks never span a
  // region boundary by construction, and region i ends exactly where
  // region i+1 begins, so walking stripes in order yields all free
  // blocks in global offset order; adjacent blocks from different
  // stripes whose offsets touch form one allocatable run.
  int64_t AllocAcrossStripes(uint64_t need) {
    std::vector<std::unique_lock<std::mutex>> locks;
    locks.reserve(num_stripes_);
    for (uint64_t i = 0; i < num_stripes_; ++i) {
      locks.emplace_back(stripes_[i].mu, std::try_to_lock);
      if (!locks.back().owns_lock()) {
        stripes_[i].contention.fetch_add(1, std::memory_order_relaxed);
        locks.back().lock();
      }
    }
    // run = contiguous sequence of free blocks across the stripe walk
    uint64_t run_start = 0, run_len = 0;
    std::vector<std::pair<uint64_t, FreeList::iterator>> run_blocks;
    for (uint64_t i = 0; i < num_stripes_; ++i) {
      for (auto it = stripes_[i].free.begin();
           it != stripes_[i].free.end(); ++it) {
        if (run_len > 0 && run_start + run_len == it->first) {
          run_len += it->second;
        } else {
          run_start = it->first;
          run_len = it->second;
          run_blocks.clear();
        }
        run_blocks.emplace_back(i, it);
        if (run_len >= need) {
          // carve [run_start, run_start+need); reinsert the remainder
          // (locks already held, so insert into the stripes directly)
          for (auto& blk : run_blocks)
            stripes_[blk.first].free.erase(blk.second);
          ForEachRegionPiece(
              run_start + need, run_len - need,
              [this](uint64_t stripe, uint64_t off, uint64_t len) {
                CoalescingInsert(stripes_[stripe].free, off, len);
              });
          return static_cast<int64_t>(run_start);
        }
      }
    }
    return -1;
  }

  // Walk [off, off+len) split at region boundaries, invoking
  // fn(stripe_index, piece_off, piece_len) per piece — the ONE place
  // that knows the region geometry (shared by the locked free path
  // and the all-locks-held cross-stripe carve).
  template <typename F>
  void ForEachRegionPiece(uint64_t off, uint64_t len, F&& fn) {
    while (len > 0) {
      uint64_t stripe = std::min(off / stripe_size_, num_stripes_ - 1);
      uint64_t region_end = stripe == num_stripes_ - 1
          ? capacity_ : (stripe + 1) * stripe_size_;
      uint64_t piece = std::min(len, region_end - off);
      fn(stripe, off, piece);
      off += piece;
      len -= piece;
    }
  }

  // Return a block to the global stripes, splitting at region
  // boundaries so coalescing stays stripe-local.
  void ReturnBlockGlobal(uint64_t off, uint64_t len) {
    ForEachRegionPiece(
        off, len, [this](uint64_t stripe, uint64_t poff, uint64_t plen) {
          ContendedLock g(stripes_[stripe].mu, stripes_[stripe].contention);
          CoalescingInsert(stripes_[stripe].free, poff, plen);
        });
  }

  void ReturnBlock(uint64_t off, uint64_t len, uint32_t b,
                   bool global_owner) {
    if (len == 0) return;
    if (global_owner) {
      ReturnBlockGlobal(off, len);
    } else {
      ContendedLock g(buckets_[b].mu, buckets_[b].contention);
      CoalescingInsert(buckets_[b].free, off, len);
    }
  }

  // Memory-pressure slow path: drain every bucket's free blocks back
  // into the global stripes so a large allocation / fresh slab can be
  // carved.  Costs other clients their warm blocks — only called when
  // the fast paths failed.
  void ReclaimBuckets() {
    std::vector<std::pair<uint64_t, uint64_t>> blocks;
    for (auto& bucket : buckets_) {
      ContendedLock g(bucket.mu, bucket.contention);
      for (auto& kv : bucket.free) blocks.emplace_back(kv.first, kv.second);
      bucket.free.clear();
    }
    for (auto& kv : blocks) ReturnBlockGlobal(kv.first, kv.second);
  }

  void TouchLocked(Shard& sh, const IdKey& id, Entry& e) {
    if (e.in_lru) sh.lru.erase(e.lru_it);
    sh.lru.push_back(id);
    e.lru_it = std::prev(sh.lru.end());
    e.in_lru = true;
    e.seq = clock_.fetch_add(1, std::memory_order_relaxed) + 1;
  }

  void FreeEntryLocked(Shard& sh,
                       std::unordered_map<IdKey, Entry, IdHash>::iterator it) {
    Entry& e = it->second;
    if (e.in_lru) sh.lru.erase(e.lru_it);
    if (e.doomed)
      doomed_current_.fetch_sub(1, std::memory_order_relaxed);
    // alloc_size == 0: a placeholder whose allocation is still in
    // flight (Create cleans up the block itself)
    ReturnBlock(e.offset, e.alloc_size, e.bucket, e.global_owner);
    used_.fetch_sub(e.alloc_size, std::memory_order_relaxed);
    if (!e.global_owner && e.alloc_size > 0)
      bucket_used_[e.bucket].fetch_sub(e.alloc_size,
                                       std::memory_order_relaxed);
    sh.table.erase(it);
  }

  // Evict globally-oldest sealed unpinned objects until ``bytes_needed``
  // are freed.  Per round: scan every shard's LRU front (one lock at a
  // time) for the smallest clock stamp, then re-lock that shard and
  // evict its front.  The scan-to-evict window is racy by design —
  // approximate global LRU, exact when uncontended.
  uint64_t EvictSome(uint64_t bytes_needed) {
    uint64_t freed = 0;
    while (freed < bytes_needed) {
      int64_t best = -1;
      uint64_t best_seq = 0;
      for (uint64_t s = 0; s < num_shards_; ++s) {
        Shard& sh = shards_[s];
        ContendedLock g(sh.mu, sh.contention);
        if (sh.lru.empty()) continue;
        auto it = sh.table.find(sh.lru.front());
        if (best < 0 || it->second.seq < best_seq) {
          best = static_cast<int64_t>(s);
          best_seq = it->second.seq;
        }
      }
      if (best < 0) break;  // nothing evictable anywhere
      Shard& sh = shards_[best];
      ContendedLock g(sh.mu, sh.contention);
      if (sh.lru.empty()) continue;  // raced away; rescan
      auto it = sh.table.find(sh.lru.front());
      // lru only holds sealed & unpinned entries by construction.
      freed += it->second.alloc_size;
      FreeEntryLocked(sh, it);
    }
    return freed;
  }

  unsigned char* base_;
  uint64_t capacity_;
  uint64_t slab_;
  uint64_t num_shards_ = kDefaultShards;
  uint64_t num_stripes_ = 1;
  uint64_t stripe_size_ = 0;
  std::atomic<uint64_t> used_{0};
  std::atomic<uint64_t> clock_{0};
  std::atomic<uint64_t> create_token_{0};
  int fd_;
  std::string path_;
  std::atomic<uint64_t> doomed_current_{0};  // deleted-while-pinned,
                                             // not yet freed
  std::atomic<uint64_t> doomed_total_{0};    // monotonic
  std::atomic<uint64_t> global_misses_{0};   // allocations > slab size
  std::array<Shard, kMaxShards> shards_;
  std::array<Stripe, kMaxStripes> stripes_;
  std::array<Bucket, kNumBuckets> buckets_;
  std::array<std::atomic<uint64_t>, kNumBuckets> bucket_used_ = {};
};

IdKey MakeKey(const unsigned char* id) {
  IdKey k;
  std::memcpy(k.b, id, kIdSize);
  return k;
}

}  // namespace

extern "C" {

// Creates (truncating) the backing file and maps it, with an explicit
// metadata shard count (0 = default).  Returns NULL on error.
void* rtpu_store_create_sharded(const char* path, uint64_t capacity,
                                uint64_t num_shards) {
  int fd = open(path, O_RDWR | O_CREAT | O_TRUNC, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, static_cast<off_t>(capacity)) != 0) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, capacity, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  return new Store(base, capacity, fd, path, num_shards);
}

void* rtpu_store_create(const char* path, uint64_t capacity) {
  return rtpu_store_create_sharded(path, capacity, 0);
}

void rtpu_store_destroy(void* handle) { delete static_cast<Store*>(handle); }

int64_t rtpu_store_put(void* handle, const unsigned char* id, uint64_t size) {
  return static_cast<Store*>(handle)->Create(MakeKey(id), size, 0);
}

// Hinted create: allocations with the same hint reuse each other's freed
// blocks (per-client page-table warmth — see the file header).
int64_t rtpu_store_put_hint(void* handle, const unsigned char* id,
                            uint64_t size, uint64_t hint) {
  return static_cast<Store*>(handle)->Create(MakeKey(id), size, hint);
}

int rtpu_store_seal(void* handle, const unsigned char* id) {
  return static_cast<Store*>(handle)->Seal(MakeKey(id)) ? 1 : 0;
}

int rtpu_store_get(void* handle, const unsigned char* id, uint64_t* offset,
                   uint64_t* size) {
  return static_cast<Store*>(handle)->Get(MakeKey(id), offset, size) ? 1 : 0;
}

int rtpu_store_release(void* handle, const unsigned char* id) {
  return static_cast<Store*>(handle)->Release(MakeKey(id)) ? 1 : 0;
}

int rtpu_store_contains(void* handle, const unsigned char* id) {
  return static_cast<Store*>(handle)->Contains(MakeKey(id)) ? 1 : 0;
}

int rtpu_store_delete(void* handle, const unsigned char* id) {
  return static_cast<Store*>(handle)->Delete(MakeKey(id)) ? 1 : 0;
}

uint64_t rtpu_store_evict(void* handle, uint64_t bytes_needed) {
  return static_cast<Store*>(handle)->Evict(bytes_needed);
}

uint64_t rtpu_store_lru_candidates(void* handle, unsigned char* out,
                                   uint64_t max_ids) {
  return static_cast<Store*>(handle)->LruCandidates(out, max_ids);
}

// Spill queue: sealed objects with pin_count <= max_pins, LRU by last
// pin; ids land in out_ids (28B each), payload sizes in out_sizes.
uint64_t rtpu_store_spill_candidates(void* handle, unsigned char* out_ids,
                                     uint64_t* out_sizes, uint64_t max_ids,
                                     uint64_t max_pins) {
  return static_cast<Store*>(handle)->SpillCandidates(out_ids, out_sizes,
                                                      max_ids, max_pins);
}

void rtpu_store_stats(void* handle, uint64_t* used, uint64_t* capacity,
                      uint64_t* num_objects) {
  static_cast<Store*>(handle)->Stats(used, capacity, num_objects);
}

// Lock-free: allocated bytes only (the per-allocation spill-pressure
// probe; Stats() sweeps every shard mutex to count objects).
uint64_t rtpu_store_used(void* handle) {
  return static_cast<Store*>(handle)->Used();
}

// Extended stats (see Store::StatsEx for the value layout); returns the
// number of values written into out (caller passes its array length).
uint64_t rtpu_store_stats_ex(void* handle, uint64_t* out, uint64_t max) {
  return static_cast<Store*>(handle)->StatsEx(out, max);
}

// Per-bucket live allocation bytes; returns entries written (<= 64).
uint64_t rtpu_store_bucket_used(void* handle, uint64_t* out, uint64_t max) {
  return static_cast<Store*>(handle)->BucketUsed(out, max);
}

// Per-shard contended-lock counts (cumulative); returns entries written.
uint64_t rtpu_store_shard_contention(void* handle, uint64_t* out,
                                     uint64_t max) {
  return static_cast<Store*>(handle)->ShardContention(out, max);
}

}  // extern "C"
