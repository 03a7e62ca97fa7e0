// Native hot/cold columnar table store.
//
// Reference parity: src/table_store/table/table.h:104 (hot/cold Table with
// unique row-id accounting, time index, byte-budget expiry, compaction) and
// table_store.h:79 (AppendData push target). The reference keeps hot writes
// in ColumnWrapper batches and compacts to Arrow cold batches; here both
// stores are plain per-column slabs sized for zero-conversion staging into
// pinned host buffers (the HBM transfer path wants contiguous fixed-width
// columns, not Arrow framing).
//
// Concurrency: one writer (ingest) + many readers (queries). A single
// mutex guards batch lists; reads copy out under the lock (bulk memcpy),
// so no view can dangle across compaction/expiry — the zero-copy-unsafe
// alternative is why reads here are copy-out by design.
//
// C ABI only (consumed via ctypes from pixie_tpu_torch/table_store/table.py);
// the same ABI as the JAX package's copy of this file.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <vector>

namespace {

struct Batch {
  int64_t first_row_id = 0;
  int64_t n = 0;
  int64_t min_time = 0;
  int64_t max_time = 0;
  int64_t bytes = 0;
  // One slab per column, each n * elem_size bytes.
  std::vector<std::unique_ptr<char[]>> cols;

  int64_t end_row_id() const { return first_row_id + n; }
};

struct Stats {
  int64_t batches_added = 0;
  int64_t batches_expired = 0;
  int64_t bytes_added = 0;
  int64_t bytes_expired = 0;
  int64_t compacted_batches = 0;
};

struct Table {
  std::vector<int32_t> elem_sizes;
  int64_t row_bytes = 0;
  int64_t compacted_rows = 0;  // target rows per cold batch
  int64_t max_bytes = -1;      // -1 = unbounded
  bool has_time = false;

  std::mutex mu;
  std::deque<Batch> hot;
  std::deque<Batch> cold;
  int64_t hot_bytes = 0;
  int64_t cold_bytes = 0;
  int64_t next_row_id = 0;
  Stats stats;

  int64_t first_row_id_locked() const {
    if (!cold.empty()) return cold.front().first_row_id;
    if (!hot.empty()) return hot.front().first_row_id;
    return next_row_id;
  }

  // Expire oldest batches until under budget. Oldest data lives at the cold
  // front; once cold is empty the hot front is oldest (reference
  // Table::ExpireBatch ordering).
  void expire_locked(int64_t incoming_bytes) {
    if (max_bytes < 0) return;
    while (hot_bytes + cold_bytes + incoming_bytes > max_bytes) {
      std::deque<Batch>* q = !cold.empty() ? &cold : (!hot.empty() ? &hot : nullptr);
      if (q == nullptr) break;
      Batch& b = q->front();
      (q == &cold ? cold_bytes : hot_bytes) -= b.bytes;
      stats.batches_expired++;
      stats.bytes_expired += b.bytes;
      q->pop_front();
    }
  }
};

// Copy rows [row_id, ...) from b into out at out_row, up to max rows total.
int64_t copy_from_batch(const Table& t, const Batch& b, int64_t row_id,
                        int64_t out_row, int64_t max_rows, void** out_cols) {
  int64_t start = std::max<int64_t>(0, row_id - b.first_row_id);
  int64_t take = std::min(b.n - start, max_rows - out_row);
  if (take <= 0) return 0;
  for (size_t c = 0; c < t.elem_sizes.size(); ++c) {
    int32_t es = t.elem_sizes[c];
    std::memcpy(static_cast<char*>(out_cols[c]) + out_row * es,
                b.cols[c].get() + start * es, take * es);
  }
  return take;
}

}  // namespace

extern "C" {

Table* pxt_table_create(int32_t ncols, const int32_t* elem_sizes,
                        int32_t has_time_col, int64_t compacted_rows,
                        int64_t max_bytes) {
  auto* t = new Table();
  t->elem_sizes.assign(elem_sizes, elem_sizes + ncols);
  for (int32_t es : t->elem_sizes) t->row_bytes += es;
  t->compacted_rows = compacted_rows > 0 ? compacted_rows : 64 * 1024;
  t->max_bytes = max_bytes;
  t->has_time = has_time_col != 0;
  return t;
}

void pxt_table_destroy(Table* t) { delete t; }

// Append n rows. cols[i] points at n*elem_sizes[i] bytes of column data;
// times points at n int64 values (ignored when the table has no time
// column). Returns the first assigned row id, or -1 on error.
int64_t pxt_table_append(Table* t, int64_t n, const void** cols,
                         const int64_t* times) {
  if (n <= 0) return -1;
  Batch b;
  b.n = n;
  b.bytes = n * t->row_bytes;
  b.cols.reserve(t->elem_sizes.size());
  for (size_t c = 0; c < t->elem_sizes.size(); ++c) {
    int64_t nbytes = n * t->elem_sizes[c];
    auto slab = std::make_unique<char[]>(nbytes);
    std::memcpy(slab.get(), cols[c], nbytes);
    b.cols.push_back(std::move(slab));
  }
  if (t->has_time && times != nullptr) {
    b.min_time = *std::min_element(times, times + n);
    b.max_time = *std::max_element(times, times + n);
  }
  std::lock_guard<std::mutex> lock(t->mu);
  t->expire_locked(b.bytes);
  b.first_row_id = t->next_row_id;
  t->next_row_id += n;
  t->hot_bytes += b.bytes;
  t->stats.batches_added++;
  t->stats.bytes_added += b.bytes;
  t->hot.push_back(std::move(b));
  return t->next_row_id - n;
}

// Merge hot batches into cold batches of ~compacted_rows rows each.
// Returns the number of cold batches created.
int64_t pxt_table_compact(Table* t) {
  std::lock_guard<std::mutex> lock(t->mu);
  int64_t created = 0;
  while (!t->hot.empty()) {
    // Gather a run of hot batches totalling >= compacted_rows (or all of
    // them — a final undersized cold batch is fine; the reference keeps
    // undersized remainders hot, but that starves low-rate tables).
    int64_t rows = 0;
    size_t take = 0;
    while (take < t->hot.size() && rows < t->compacted_rows) {
      rows += t->hot[take].n;
      take++;
    }
    Batch merged;
    merged.n = rows;
    merged.bytes = rows * t->row_bytes;
    merged.first_row_id = t->hot.front().first_row_id;
    merged.min_time = t->hot.front().min_time;
    merged.max_time = t->hot.front().max_time;
    merged.cols.reserve(t->elem_sizes.size());
    for (size_t c = 0; c < t->elem_sizes.size(); ++c)
      merged.cols.push_back(std::make_unique<char[]>(rows * t->elem_sizes[c]));
    int64_t off = 0;
    for (size_t i = 0; i < take; ++i) {
      Batch& h = t->hot[i];
      for (size_t c = 0; c < t->elem_sizes.size(); ++c) {
        int32_t es = t->elem_sizes[c];
        std::memcpy(merged.cols[c].get() + off * es, h.cols[c].get(), h.n * es);
      }
      off += h.n;
      merged.min_time = std::min(merged.min_time, h.min_time);
      merged.max_time = std::max(merged.max_time, h.max_time);
    }
    t->hot.erase(t->hot.begin(), t->hot.begin() + take);
    t->hot_bytes -= merged.bytes;
    t->cold_bytes += merged.bytes;
    t->stats.compacted_batches++;
    t->cold.push_back(std::move(merged));
    created++;
  }
  return created;
}

// Drop every row with id < row_id. This is the cold-tier demotion handoff
// (table_store/tier.py): the caller has already copied these rows into the encoded
// cold store, so the drop is NOT expiry — batches_expired / bytes_expired
// do not move (they are reserved for true data loss). Row-granular: a
// batch straddling row_id is split and its tail kept, so the invariant
// "cold tier end == hot first_row_id" holds exactly. Returns the new
// first row id.
int64_t pxt_table_drop_before(Table* t, int64_t row_id) {
  std::lock_guard<std::mutex> lock(t->mu);
  for (std::deque<Batch>* q : {&t->cold, &t->hot}) {
    int64_t& qbytes = (q == &t->cold) ? t->cold_bytes : t->hot_bytes;
    while (!q->empty()) {
      Batch& b = q->front();
      if (b.end_row_id() <= row_id) {
        qbytes -= b.bytes;
        q->pop_front();
        continue;
      }
      if (b.first_row_id < row_id) {
        int64_t drop = row_id - b.first_row_id;
        int64_t keep = b.n - drop;
        Batch tail;
        tail.first_row_id = row_id;
        tail.n = keep;
        tail.bytes = keep * t->row_bytes;
        tail.cols.reserve(t->elem_sizes.size());
        for (size_t c = 0; c < t->elem_sizes.size(); ++c) {
          int32_t es = t->elem_sizes[c];
          auto slab = std::make_unique<char[]>(keep * es);
          std::memcpy(slab.get(), b.cols[c].get() + drop * es, keep * es);
          tail.cols.push_back(std::move(slab));
        }
        if (t->has_time) {
          const int64_t* times =
              reinterpret_cast<const int64_t*>(tail.cols[0].get());
          tail.min_time = *std::min_element(times, times + keep);
          tail.max_time = *std::max_element(times, times + keep);
        }
        qbytes += tail.bytes - b.bytes;
        q->front() = std::move(tail);
      }
      // Front batch now starts at or after row_id; later batches are
      // strictly newer, so the sweep is complete.
      return t->first_row_id_locked();
    }
  }
  return t->first_row_id_locked();
}

int64_t pxt_table_first_row_id(Table* t) {
  std::lock_guard<std::mutex> lock(t->mu);
  return t->first_row_id_locked();
}

int64_t pxt_table_end_row_id(Table* t) {
  std::lock_guard<std::mutex> lock(t->mu);
  return t->next_row_id;
}

// First row id whose time is >= time (strict > when strictly_greater).
// Scans batch min/max time summaries, then the row times within the
// boundary batch. Assumes times are non-decreasing across appends (true of
// telemetry streams; matches the reference's sorted time index).
int64_t pxt_table_row_id_for_time(Table* t, int64_t time,
                                  int32_t strictly_greater) {
  std::lock_guard<std::mutex> lock(t->mu);
  if (!t->has_time) return t->first_row_id_locked();
  auto scan = [&](const std::deque<Batch>& q) -> int64_t {
    for (const Batch& b : q) {
      bool hit = strictly_greater ? (b.max_time > time) : (b.max_time >= time);
      if (!hit) continue;
      // Times are column 0 by convention when has_time (see table.py).
      const int64_t* times = reinterpret_cast<const int64_t*>(b.cols[0].get());
      for (int64_t i = 0; i < b.n; ++i) {
        if (strictly_greater ? times[i] > time : times[i] >= time)
          return b.first_row_id + i;
      }
    }
    return -1;
  };
  int64_t r = scan(t->cold);
  if (r >= 0) return r;
  r = scan(t->hot);
  if (r >= 0) return r;
  return t->next_row_id;
}

// Copy up to max_rows rows starting at start_row_id (or the first still-
// unexpired row after it) into out_cols. Returns rows copied; stores the
// id of the first copied row in *out_first_row_id (so cursors detect
// expiry skips).
int64_t pxt_table_read(Table* t, int64_t start_row_id, int64_t max_rows,
                       void** out_cols, int64_t* out_first_row_id) {
  std::lock_guard<std::mutex> lock(t->mu);
  int64_t row_id = std::max(start_row_id, t->first_row_id_locked());
  *out_first_row_id = row_id;
  int64_t copied = 0;
  for (const std::deque<Batch>* q : {&t->cold, &t->hot}) {
    for (const Batch& b : *q) {
      if (b.end_row_id() <= row_id) continue;
      int64_t take =
          copy_from_batch(*t, b, row_id + copied, copied, max_rows, out_cols);
      copied += take;
      if (copied >= max_rows) return copied;
    }
  }
  return copied;
}

// out[10] = {bytes, hot_bytes, cold_bytes, num_batches, batches_added,
//            batches_expired, bytes_added, compacted_batches, min_time,
//            num_rows}
void pxt_table_stats(Table* t, int64_t* out) {
  std::lock_guard<std::mutex> lock(t->mu);
  out[0] = t->hot_bytes + t->cold_bytes;
  out[1] = t->hot_bytes;
  out[2] = t->cold_bytes;
  out[3] = static_cast<int64_t>(t->hot.size() + t->cold.size());
  out[4] = t->stats.batches_added;
  out[5] = t->stats.batches_expired;
  out[6] = t->stats.bytes_added;
  out[7] = t->stats.compacted_batches;
  out[8] = !t->cold.empty() ? t->cold.front().min_time
                            : (!t->hot.empty() ? t->hot.front().min_time : -1);
  out[9] = t->next_row_id - t->first_row_id_locked();
}

}  // extern "C"
