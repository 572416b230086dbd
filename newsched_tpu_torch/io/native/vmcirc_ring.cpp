// Double-mapped circular buffer + SPSC queue + pump and drain threads
// (reference: newsched_tpu/io/native/vmcirc_ring.cpp, the same code).
//
// The rebuild of GNU Radio's buffer_cpu_vmcirc: the same pages are mapped
// twice back-to-back so every read/write window is linear across the wrap,
// with no copy on the wrap. A native pump thread streams a file (or any
// fd: a socket, a pipe) into the ring at page-cache speed while Python
// drains fixed-size batches for the runner's host staging
// (newsched_tpu_torch/blocks/fileio.py file_source host_pull); a drain
// thread writes a ring to an fd (the socket sinks).
//
// Built at first use by newsched_tpu_torch/io/native_ring.py:
//   g++ -O2 -shared -fPIC -o libvmcirc_<hash>.so vmcirc_ring.cpp -lpthread
// Binding: ctypes, a plain C interface. The reference's staging allocator
// is not copied: the port stages batches in pinned torch tensors
// (runtime/runner.py _Staging).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <fcntl.h>
#include <poll.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Ring {
    uint8_t* base = nullptr;   // double-mapped region of 2*size bytes
    size_t size = 0;           // capacity in bytes (page multiple)
    std::atomic<uint64_t> head{0};  // written bytes (producer)
    std::atomic<uint64_t> tail{0};  // consumed bytes (consumer)
    // pump thread state
    pthread_t pump_thread{};
    int pump_fd = -1;
    int pump_owns_fd = 1;      // close fd on destroy/stop (0 for borrowed fds)
    int pump_loop = 0;
    std::atomic<int> pump_running{0};
    std::atomic<int> pump_eof{0};
    // drain (ring -> fd) thread state
    pthread_t drain_thread{};
    int drain_fd = -1;
    int drain_owns_fd = 1;
    double drain_rate = 0.0;   // bytes/s pacing; 0 = unpaced
    size_t drain_chunk = 0;    // max bytes per write() (UDP datagram size); 0 = unlimited
    std::atomic<int> drain_running{0};
    std::atomic<int> drain_done{0};
    std::atomic<uint64_t> drain_bytes{0};
};

void* pump_main(void* arg) {
    Ring* r = static_cast<Ring*>(arg);
    while (r->pump_running.load(std::memory_order_acquire)) {
        uint64_t head = r->head.load(std::memory_order_relaxed);
        uint64_t tail = r->tail.load(std::memory_order_acquire);
        size_t space = r->size - static_cast<size_t>(head - tail);
        if (space == 0) {
            struct timespec ts {0, 200000};  // 200 us
            nanosleep(&ts, nullptr);
            continue;
        }
        // poll so a blocking fd (idle socket) cannot wedge shutdown:
        // the loop re-checks pump_running every 100 ms
        struct pollfd pfd {r->pump_fd, POLLIN, 0};
        int pr = poll(&pfd, 1, 100);
        if (pr < 0) {
            r->pump_eof.store(1, std::memory_order_release);
            break;
        }
        if (pr == 0) continue;  // timeout: nothing readable yet
        uint8_t* dst = r->base + (head % r->size);
        ssize_t n = read(r->pump_fd, dst, space);
        if (n > 0) {
            r->head.store(head + static_cast<uint64_t>(n), std::memory_order_release);
        } else if (n == 0) {
            if (r->pump_loop) {
                lseek(r->pump_fd, 0, SEEK_SET);
            } else {
                r->pump_eof.store(1, std::memory_order_release);
                break;
            }
        } else {
            r->pump_eof.store(1, std::memory_order_release);
            break;
        }
    }
    return nullptr;
}

// Drain thread: ring -> fd, optionally paced to drain_rate bytes/s
// (the native analog of the reference's throttle block on the egress
// side; unpaced it is a full-speed file/socket sink pump).
void* drain_main(void* arg) {
    Ring* r = static_cast<Ring*>(arg);
    struct timespec start;
    clock_gettime(CLOCK_MONOTONIC, &start);
    while (r->drain_running.load(std::memory_order_acquire)) {
        uint64_t head = r->head.load(std::memory_order_acquire);
        uint64_t tail = r->tail.load(std::memory_order_relaxed);
        size_t avail = static_cast<size_t>(head - tail);
        if (avail == 0) {
            if (r->pump_eof.load(std::memory_order_acquire)) break;
            struct timespec ts {0, 200000};
            nanosleep(&ts, nullptr);
            continue;
        }
        if (r->drain_rate > 0.0) {
            // only release bytes the rate budget allows
            struct timespec now;
            clock_gettime(CLOCK_MONOTONIC, &now);
            double el = (now.tv_sec - start.tv_sec) + 1e-9 * (now.tv_nsec - start.tv_nsec);
            uint64_t budget = static_cast<uint64_t>(el * r->drain_rate);
            uint64_t sent = r->drain_bytes.load(std::memory_order_relaxed);
            if (sent >= budget) {
                struct timespec ts {0, 200000};
                nanosleep(&ts, nullptr);
                continue;
            }
            uint64_t allow = budget - sent;
            if (avail > allow) avail = static_cast<size_t>(allow);
        }
        if (r->drain_chunk && avail > r->drain_chunk) avail = r->drain_chunk;
        struct pollfd pfd {r->drain_fd, POLLOUT, 0};
        int pr = poll(&pfd, 1, 100);
        if (pr < 0) break;
        if (pr == 0) continue;  // peer not writable yet; re-check running flag
        uint8_t* src = r->base + (tail % r->size);
        ssize_t n = write(r->drain_fd, src, avail);
        if (n > 0) {
            r->tail.store(tail + static_cast<uint64_t>(n), std::memory_order_release);
            r->drain_bytes.fetch_add(static_cast<uint64_t>(n), std::memory_order_relaxed);
        } else if (n < 0) {
            break;  // sink error: stop draining (Python observes drain_done)
        }
    }
    r->drain_done.store(1, std::memory_order_release);
    return nullptr;
}

}  // namespace

extern "C" {

// Create a double-mapped ring of at least `min_size` bytes. Returns an
// opaque handle or nullptr.
void* ring_create(size_t min_size) {
    long page = sysconf(_SC_PAGESIZE);
    size_t size = ((min_size + page - 1) / page) * page;
    int fd = memfd_create("newsched_vmcirc", 0);
    if (fd < 0) return nullptr;
    if (ftruncate(fd, static_cast<off_t>(size)) != 0) {
        close(fd);
        return nullptr;
    }
    // Reserve 2*size of address space, then map the same pages twice.
    uint8_t* base = static_cast<uint8_t*>(
        mmap(nullptr, 2 * size, PROT_NONE, MAP_PRIVATE | MAP_ANONYMOUS, -1, 0));
    if (base == MAP_FAILED) {
        close(fd);
        return nullptr;
    }
    if (mmap(base, size, PROT_READ | PROT_WRITE, MAP_SHARED | MAP_FIXED, fd, 0) ==
            MAP_FAILED ||
        mmap(base + size, size, PROT_READ | PROT_WRITE, MAP_SHARED | MAP_FIXED, fd,
             0) == MAP_FAILED) {
        munmap(base, 2 * size);
        close(fd);
        return nullptr;
    }
    close(fd);  // mappings keep the pages alive
    Ring* r = new Ring();
    r->base = base;
    r->size = size;
    return r;
}

void ring_destroy(void* h) {
    Ring* r = static_cast<Ring*>(h);
    if (!r) return;
    if (r->pump_running.load()) {
        r->pump_running.store(0);
        pthread_join(r->pump_thread, nullptr);
    }
    if (r->drain_running.load()) {
        r->drain_running.store(0);
        pthread_join(r->drain_thread, nullptr);
    }
    if (r->pump_fd >= 0 && r->pump_owns_fd) close(r->pump_fd);
    if (r->drain_fd >= 0 && r->drain_owns_fd) close(r->drain_fd);
    munmap(r->base, 2 * r->size);
    delete r;
}

size_t ring_capacity(void* h) { return static_cast<Ring*>(h)->size; }

// Bytes available to read.
size_t ring_read_avail(void* h) {
    Ring* r = static_cast<Ring*>(h);
    return static_cast<size_t>(r->head.load(std::memory_order_acquire) -
                               r->tail.load(std::memory_order_relaxed));
}

size_t ring_write_avail(void* h) {
    Ring* r = static_cast<Ring*>(h);
    return r->size - static_cast<size_t>(r->head.load(std::memory_order_relaxed) -
                                         r->tail.load(std::memory_order_acquire));
}

// Pointer to the current linear read window (valid for ring_read_avail
// bytes thanks to the double mapping).
uint8_t* ring_read_ptr(void* h) {
    Ring* r = static_cast<Ring*>(h);
    return r->base + (r->tail.load(std::memory_order_relaxed) % r->size);
}

void ring_read_commit(void* h, size_t n) {
    Ring* r = static_cast<Ring*>(h);
    r->tail.fetch_add(n, std::memory_order_release);
}

uint8_t* ring_write_ptr(void* h) {
    Ring* r = static_cast<Ring*>(h);
    return r->base + (r->head.load(std::memory_order_relaxed) % r->size);
}

void ring_write_commit(void* h, size_t n) {
    Ring* r = static_cast<Ring*>(h);
    r->head.fetch_add(n, std::memory_order_release);
}

// Copy-out read (for callers that want their own buffer). Returns bytes read.
size_t ring_read(void* h, uint8_t* dst, size_t n) {
    Ring* r = static_cast<Ring*>(h);
    size_t avail = ring_read_avail(h);
    size_t take = n < avail ? n : avail;
    memcpy(dst, ring_read_ptr(h), take);
    r->tail.fetch_add(take, std::memory_order_release);
    return take;
}

size_t ring_write(void* h, const uint8_t* src, size_t n) {
    Ring* r = static_cast<Ring*>(h);
    size_t space = ring_write_avail(h);
    size_t put = n < space ? n : space;
    memcpy(ring_write_ptr(h), src, put);
    r->head.fetch_add(put, std::memory_order_release);
    return put;
}

// Start a background thread streaming `path` into the ring.
int ring_start_file_pump(void* h, const char* path, int loop) {
    Ring* r = static_cast<Ring*>(h);
    r->pump_fd = open(path, O_RDONLY);
    if (r->pump_fd < 0) return -1;
    r->pump_loop = loop;
    r->pump_eof.store(0);
    r->pump_running.store(1);
    if (pthread_create(&r->pump_thread, nullptr, pump_main, r) != 0) {
        r->pump_running.store(0);
        close(r->pump_fd);
        r->pump_fd = -1;
        return -2;
    }
    return 0;
}

int ring_pump_eof(void* h) { return static_cast<Ring*>(h)->pump_eof.load(); }

void ring_stop_pump(void* h) {
    Ring* r = static_cast<Ring*>(h);
    if (r->pump_running.load()) {
        r->pump_running.store(0);
        pthread_join(r->pump_thread, nullptr);
    }
}

// Start a background thread streaming an already-open fd into the ring
// (sockets, pipes, character devices — Python owns the fd lifecycle when
// owns_fd=0). Generalizes the file pump: the reference's buffer_net/zmq
// ingest path maps onto this, with Python only doing connection setup.
int ring_start_fd_pump(void* h, int fd, int owns_fd) {
    Ring* r = static_cast<Ring*>(h);
    if (fd < 0) return -1;
    r->pump_fd = fd;
    r->pump_owns_fd = owns_fd;
    r->pump_loop = 0;
    r->pump_eof.store(0);
    r->pump_running.store(1);
    if (pthread_create(&r->pump_thread, nullptr, pump_main, r) != 0) {
        r->pump_running.store(0);
        r->pump_fd = -1;
        return -2;
    }
    return 0;
}

// Mark producer-side end-of-stream so a drain pump can finish after the
// ring empties (used when Python is the producer via ring_write).
void ring_set_eof(void* h) {
    static_cast<Ring*>(h)->pump_eof.store(1, std::memory_order_release);
}

// Start a background thread draining the ring into fd, optionally paced
// to rate_bps bytes/s (0 = full speed). fd may be a file or socket.
int ring_start_fd_drain(void* h, int fd, int owns_fd, double rate_bps,
                        size_t max_chunk) {
    Ring* r = static_cast<Ring*>(h);
    if (fd < 0) return -1;
    r->drain_fd = fd;
    r->drain_owns_fd = owns_fd;
    r->drain_rate = rate_bps;
    r->drain_chunk = max_chunk;
    r->drain_done.store(0);
    r->drain_bytes.store(0);
    r->drain_running.store(1);
    if (pthread_create(&r->drain_thread, nullptr, drain_main, r) != 0) {
        r->drain_running.store(0);
        r->drain_fd = -1;
        return -2;
    }
    return 0;
}

int ring_start_file_drain(void* h, const char* path, double rate_bps) {
    int fd = open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
    if (fd < 0) return -1;
    int rc = ring_start_fd_drain(h, fd, 1, rate_bps, 0);
    if (rc != 0) close(fd);
    return rc;
}

int ring_drain_done(void* h) { return static_cast<Ring*>(h)->drain_done.load(); }

uint64_t ring_drain_bytes(void* h) {
    return static_cast<Ring*>(h)->drain_bytes.load(std::memory_order_relaxed);
}

void ring_stop_drain(void* h) {
    Ring* r = static_cast<Ring*>(h);
    if (r->drain_running.load()) {
        r->drain_running.store(0);
        pthread_join(r->drain_thread, nullptr);
    }
}

}  // extern "C"
