// Threaded shot-gather block prefetcher — the framework's native data
// loader. Background worker threads pread() fixed-size blocks (shot
// gathers) from a raw store into a bounded ring of buffers while the card
// computes; the Python side drains the ring and copies to the device.
//
// The port's copy of jets_tpu/utils/_dataloader.cpp (the same code): the
// reference repo has no native code; this keeps host-side IO off the
// Python thread that drives the device.
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <queue>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Block {
    int64_t index;
    bool ok = false;  // full block_bytes read; short reads yield ok=false
    std::vector<uint8_t> data;
};

struct Loader {
    int fd = -1;
    int64_t block_bytes = 0;
    int64_t nblocks = 0;
    int64_t next_to_read = 0;   // producer cursor
    int64_t next_to_emit = 0;   // consumer cursor (ordered delivery)
    size_t queue_depth = 4;
    bool failed = false;

    std::mutex mu;
    std::condition_variable cv_space, cv_data;
    // min-heap by index would be overkill: single producer reads in order.
    std::queue<Block> ready;
    std::thread worker;
    std::atomic<bool> stop{false};

    void run() {
        while (!stop.load()) {
            int64_t idx;
            {
                std::unique_lock<std::mutex> lk(mu);
                if (next_to_read >= nblocks) break;
                cv_space.wait(lk, [&] {
                    return stop.load() || ready.size() < queue_depth;
                });
                if (stop.load()) break;
                idx = next_to_read++;
            }
            Block b;
            b.index = idx;
            b.data.resize(block_bytes);
            int64_t off = idx * block_bytes;
            int64_t got = 0;
            while (got < block_bytes) {
                ssize_t r = pread(fd, b.data.data() + got,
                                  block_bytes - got, off + got);
                if (r <= 0) break;
                got += r;
            }
            b.ok = (got == block_bytes);
            {
                std::lock_guard<std::mutex> lk(mu);
                if (!b.ok) failed = true;
                ready.push(std::move(b));
            }
            cv_data.notify_one();
        }
        {
            std::lock_guard<std::mutex> lk(mu);
        }
        cv_data.notify_all();
    }
};

}  // namespace

extern "C" {

void* jets_loader_open(const char* path, int64_t block_bytes,
                       int64_t nblocks, int queue_depth) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    Loader* L = new Loader();
    L->fd = fd;
    L->block_bytes = block_bytes;
    L->nblocks = nblocks;
    L->queue_depth = queue_depth > 0 ? queue_depth : 4;
    L->worker = std::thread([L] { L->run(); });
    return L;
}

// Copies the next block (in order) into dst; returns its index, or -1 when
// exhausted, or -2 on read failure.
int64_t jets_loader_next(void* h, uint8_t* dst) {
    Loader* L = static_cast<Loader*>(h);
    std::unique_lock<std::mutex> lk(L->mu);
    if (L->next_to_emit >= L->nblocks) return -1;
    L->cv_data.wait(lk, [&] { return !L->ready.empty() || L->failed; });
    if (L->ready.empty()) return -2;
    Block b = std::move(L->ready.front());
    L->ready.pop();
    L->cv_space.notify_one();
    if (!b.ok) return -2;  // truncated/corrupt block: surface, never yield
    L->next_to_emit = b.index + 1;
    lk.unlock();
    std::memcpy(dst, b.data.data(), b.data.size());
    return b.index;
}

void jets_loader_close(void* h) {
    Loader* L = static_cast<Loader*>(h);
    L->stop.store(true);
    L->cv_space.notify_all();
    L->cv_data.notify_all();
    if (L->worker.joinable()) L->worker.join();
    close(L->fd);
    delete L;
}

}  // extern "C"
