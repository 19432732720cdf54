// chainermn_native (the port's copy) — the host side of batch assembly.
//
// The port's own copy of the JAX package's native/chainermn_native.cpp,
// cut to what chainermn_torch/training/loader.py uses:
//
// a double-buffered prefetching batch loader: a worker thread assembles
// the next batch into a reusable buffer (a threaded strided row gather,
// out[i] = base[indices[i]]) while the device runs the current step.
//
// Exposed as a plain C ABI for ctypes; chainermn_torch/ops/native.py
// builds it with g++ at first use and binds it.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

void parallel_for(int64_t n, int n_threads, void (*fn)(int64_t, int64_t, void*),
                  void* ctx) {
  if (n_threads <= 1 || n < 2) {
    fn(0, n, ctx);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    ts.emplace_back([=] { fn(lo, hi, ctx); });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// threaded row gather: out[i, :] = base[indices[i], :]
// ---------------------------------------------------------------------------

struct GatherCtx {
  const char* base;
  int64_t row_bytes;
  const int64_t* indices;
  char* out;
};

static void gather_range(int64_t lo, int64_t hi, void* vctx) {
  auto* c = static_cast<GatherCtx*>(vctx);
  for (int64_t i = lo; i < hi; ++i)
    std::memcpy(c->out + i * c->row_bytes,
                c->base + c->indices[i] * c->row_bytes,
                static_cast<size_t>(c->row_bytes));
}

// ---------------------------------------------------------------------------
// double-buffered prefetching loader
// ---------------------------------------------------------------------------
//
// The loader owns `depth` reusable buffers per stream (x and y). submit()
// enqueues an index set; a worker thread gathers rows into the next free
// buffer; next() blocks until the oldest submitted batch is ready and
// returns its buffer id. The Python side wraps buffer ids as numpy views.

struct Loader {
  const char* xbase;
  const char* ybase;
  int64_t xrow, yrow;  // bytes per row
  int64_t batch;       // rows per batch
  int depth;
  int n_threads;
  std::vector<std::vector<char>> xbuf, ybuf;

  std::mutex mu;
  std::condition_variable cv;
  std::queue<std::vector<int64_t>> pending;  // submitted index sets
  std::queue<int> ready;                     // finished buffer ids
  std::queue<int> freebufs;
  std::atomic<bool> stop{false};
  std::thread worker;

  Loader(const void* xb, const void* yb, int64_t xr, int64_t yr, int64_t b,
         int d, int nt)
      : xbase(static_cast<const char*>(xb)),
        ybase(static_cast<const char*>(yb)),
        xrow(xr), yrow(yr), batch(b), depth(d), n_threads(nt) {
    xbuf.resize(depth);
    ybuf.resize(depth);
    for (int i = 0; i < depth; ++i) {
      xbuf[i].resize(static_cast<size_t>(xrow * batch));
      ybuf[i].resize(static_cast<size_t>(yrow * batch));
      freebufs.push(i);
    }
    worker = std::thread([this] { run(); });
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> l(mu);
      stop = true;
    }
    cv.notify_all();
    worker.join();
  }

  void run() {
    for (;;) {
      std::vector<int64_t> idx;
      int buf;
      {
        std::unique_lock<std::mutex> l(mu);
        cv.wait(l, [this] {
          return stop || (!pending.empty() && !freebufs.empty());
        });
        if (stop) return;
        idx = std::move(pending.front());
        pending.pop();
        buf = freebufs.front();
        freebufs.pop();
      }
      GatherCtx cx{xbase, xrow, idx.data(), xbuf[buf].data()};
      parallel_for(static_cast<int64_t>(idx.size()), n_threads, gather_range,
                   &cx);
      GatherCtx cy{ybase, yrow, idx.data(), ybuf[buf].data()};
      parallel_for(static_cast<int64_t>(idx.size()), n_threads, gather_range,
                   &cy);
      {
        std::lock_guard<std::mutex> l(mu);
        ready.push(buf);
      }
      cv.notify_all();
    }
  }
};

void* cmn_loader_create(const void* xbase, const void* ybase, int64_t xrow,
                        int64_t yrow, int64_t batch, int depth,
                        int n_threads) {
  return new Loader(xbase, ybase, xrow, yrow, batch, depth, n_threads);
}

void cmn_loader_submit(void* h, const int64_t* indices, int64_t n) {
  auto* l = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(l->mu);
    l->pending.emplace(indices, indices + n);
  }
  l->cv.notify_all();
}

// Blocks until a batch is ready; returns buffer id and writes x/y pointers.
int cmn_loader_next(void* h, void** xout, void** yout) {
  auto* l = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> lk(l->mu);
  l->cv.wait(lk, [l] { return !l->ready.empty(); });
  int buf = l->ready.front();
  l->ready.pop();
  *xout = l->xbuf[buf].data();
  *yout = l->ybuf[buf].data();
  return buf;
}

// Return a buffer to the free pool once the device owns a copy.
void cmn_loader_release(void* h, int buf) {
  auto* l = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(l->mu);
    l->freebufs.push(buf);
  }
  l->cv.notify_all();
}

void cmn_loader_destroy(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
