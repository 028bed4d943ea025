// Host-side prefetching record pipeline (≙ utils/ThreadPool.scala +
// dataset/image/LocalSeqFileToBytes.scala's multi-threaded record feed).
//
// Worker threads stream fixed-length records from a list of files (mmap'd)
// into a bounded ring buffer; the consumer (the python data pipeline
// feeding the device) pops records without touching the page cache on the
// critical path.  The device step and host IO overlap: while the device runs step N,
// workers fill the ring for steps N+1..N+capacity.
//
// C ABI (ctypes): pf_create / pf_next / pf_size / pf_destroy.
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <memory>
#include <mutex>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct MappedFile {
    const uint8_t* data = nullptr;
    size_t size = 0;
    int fd = -1;

    bool open_map(const char* path) {
        fd = ::open(path, O_RDONLY);
        if (fd < 0) return false;
        struct stat st;
        if (fstat(fd, &st) != 0) { ::close(fd); return false; }
        size = size_t(st.st_size);
        if (size == 0) { data = nullptr; return true; }
        void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
        if (p == MAP_FAILED) { ::close(fd); return false; }
        madvise(p, size, MADV_SEQUENTIAL);
        data = static_cast<const uint8_t*>(p);
        return true;
    }

    ~MappedFile() {
        if (data) munmap(const_cast<uint8_t*>(data), size);
        if (fd >= 0) ::close(fd);
    }
};

struct Prefetcher {
    std::vector<std::unique_ptr<MappedFile>> files;
    size_t record_bytes;
    size_t header_bytes;
    size_t capacity;           // ring slots
    bool loop;                 // rewind at EOF (epoch streaming)

    std::vector<uint8_t> ring;           // capacity * record_bytes
    std::vector<size_t> lens;
    size_t head = 0, tail = 0, count = 0;
    bool done = false;
    std::mutex mu;
    std::condition_variable not_full, not_empty;
    std::vector<std::thread> workers;
    std::atomic<size_t> next_file{0};

    Prefetcher(std::vector<std::string> paths, size_t rec, size_t hdr,
               size_t cap, int n_workers, bool loop_)
        : record_bytes(rec), header_bytes(hdr), capacity(cap), loop(loop_) {
        for (auto& p : paths) {
            auto mf = std::make_unique<MappedFile>();
            if (mf->open_map(p.c_str())) files.push_back(std::move(mf));
        }
        ring.resize(capacity * record_bytes);
        lens.resize(capacity);
        active_workers = n_workers;  // BEFORE threads start: a fast worker
                                     // must not decrement from zero
        for (int i = 0; i < n_workers; i++)
            workers.emplace_back([this] { run(); });
    }

    bool stopping() {
        std::lock_guard<std::mutex> lk(mu);
        return done;
    }

    void push(const uint8_t* src, size_t len) {
        std::unique_lock<std::mutex> lk(mu);
        not_full.wait(lk, [this] { return count < capacity || done; });
        if (done) return;
        std::memcpy(&ring[tail * record_bytes], src, len);
        lens[tail] = len;
        tail = (tail + 1) % capacity;
        count++;
        not_empty.notify_one();
    }

    void run() {
        // each worker claims whole files (coarse parallelism: files are
        // shards, records inside stay ordered)
        for (;;) {
            if (stopping() || files.empty()) break;
            size_t fi = next_file.fetch_add(1);
            if (fi >= files.size()) {
                if (!loop) break;
                fi %= files.size();
            }
            MappedFile& f = *files[fi];
            size_t off = header_bytes;
            while (off + record_bytes <= f.size) {
                if (stopping()) break;
                push(f.data + off, record_bytes);
                off += record_bytes;
            }
        }
        std::lock_guard<std::mutex> lk(mu);
        // last worker out marks the stream finished
        if (--active_workers == 0 && !loop) {
            finished = true;
            not_empty.notify_all();
        }
    }

    int active_workers = 0;
    bool finished = false;

    // returns record length, 0 at end-of-stream
    size_t next(uint8_t* out) {
        std::unique_lock<std::mutex> lk(mu);
        not_empty.wait(lk, [this] { return count > 0 || finished || done; });
        if (count == 0) return 0;
        size_t len = lens[head];
        std::memcpy(out, &ring[head * record_bytes], len);
        head = (head + 1) % capacity;
        count--;
        not_full.notify_one();
        return len;
    }

    ~Prefetcher() {
        {
            std::lock_guard<std::mutex> lk(mu);
            done = true;
        }
        not_full.notify_all();
        not_empty.notify_all();
        for (auto& t : workers)
            if (t.joinable()) t.join();
    }
};

}  // namespace

extern "C" {

void* pf_create(const char** paths, int n_paths, uint64_t record_bytes,
                uint64_t header_bytes, uint64_t capacity, int n_workers,
                int loop) {
    std::vector<std::string> ps(paths, paths + n_paths);
    return new Prefetcher(ps, record_bytes, header_bytes, capacity,
                          n_workers, loop != 0);
}

uint64_t pf_next(void* handle, uint8_t* out) {
    return static_cast<Prefetcher*>(handle)->next(out);
}

uint64_t pf_buffered(void* handle) {
    return static_cast<Prefetcher*>(handle)->count;
}

void pf_destroy(void* handle) {
    delete static_cast<Prefetcher*>(handle);
}

}  // extern "C"
