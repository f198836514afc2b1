// gwt_native: host-side native runtime of the PyTorch port.
//
// The port's own copy of native/gwt_native.cpp, which the JAX package builds
// and binds; that file stays as the JAX package has it. The reference
// delegates its entire host runtime to C++ — the GNU Radio scheduler's
// lock-free ring buffers (implicit in every connect(), SURVEY.md §2.3 last
// row), the network.socket_pdu UDP bridge (IRS_user.grc:299-318), and the
// ieee802_11.mac framer + CRC-32 FCS (IRS_user.py:192). This translation
// unit provides the equivalents for everything that runs on the host:
//
//   * a single-producer/single-consumer lock-free ring buffer for complex64
//     sample streams (the GNU Radio ring-buffer analogue, used to stage
//     samples between the UDP/radio ingest thread and the device feeder);
//   * a threaded UDP PDU source/sink (socket_pdu analogue) whose receive
//     loop runs off the Python GIL; the port's copy also keeps each queued
//     datagram's receive time and counts the datagrams its drop-oldest
//     policy discards (the stamps_ns of gwt_udp_source_drain,
//     gwt_udp_source_dropped);
//   * table-driven CRC-32 (IEEE, reflected) and a batched 802.11 data-MPDU
//     framer / FCS checker (the ieee802_11.mac hot loop).
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (gnuradio_wifi_imagetransfer_tpu_torch/runtime/native.py); every entry
// point has a pure-Python fallback so correctness never depends on this
// library.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread gwt_native.cpp -o libgwt_native.so

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// CRC-32 (IEEE 802.3 reflected, poly 0xEDB88320) — the FCS algorithm used by
// ieee802_11.mac / decode_mac. Table built once at load time.
// ---------------------------------------------------------------------------

static uint32_t g_crc_table[256];

static void crc_init() {
    for (uint32_t i = 0; i < 256; ++i) {
        uint32_t c = i;
        for (int k = 0; k < 8; ++k)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        g_crc_table[i] = c;
    }
}

struct CrcInitializer { CrcInitializer() { crc_init(); } };
static CrcInitializer g_crc_init;

uint32_t gwt_crc32(const uint8_t* data, int64_t n) {
    uint32_t crc = 0xFFFFFFFFu;
    for (int64_t i = 0; i < n; ++i)
        crc = g_crc_table[(crc ^ data[i]) & 0xFFu] ^ (crc >> 8);
    return crc ^ 0xFFFFFFFFu;
}

// Batched MPDU builder mirroring phy/mac.py frame_batch (and the reference's
// ieee802_11.mac, IRS_user.py:192): 24-byte data header (frame control
// 0x0008, duration 0x002E, dst/src/bss, 12-bit seq<<4 LE) + payload +
// little-endian CRC-32 FCS. payloads: (B, L) row-major; out: (B, L+28).
void gwt_frame_batch(const uint8_t* payloads, int64_t b, int64_t l,
                     uint32_t seq0, const uint8_t* src, const uint8_t* dst,
                     const uint8_t* bss, uint8_t* out) {
    const int64_t mlen = 24 + l + 4;
    uint8_t hdr[22];
    hdr[0] = 0x08; hdr[1] = 0x00;            // frame control (LE)
    hdr[2] = 0x2E; hdr[3] = 0x00;            // duration
    std::memcpy(hdr + 4, dst, 6);
    std::memcpy(hdr + 10, src, 6);
    std::memcpy(hdr + 16, bss, 6);
    for (int64_t i = 0; i < b; ++i) {
        uint8_t* row = out + i * mlen;
        std::memcpy(row, hdr, 22);
        uint32_t seq = ((seq0 + (uint32_t)i) & 0xFFFu) << 4;
        row[22] = (uint8_t)(seq & 0xFF);
        row[23] = (uint8_t)(seq >> 8);
        std::memcpy(row + 24, payloads + i * l, l);
        uint32_t crc = gwt_crc32(row, 24 + l);
        row[24 + l + 0] = (uint8_t)(crc);
        row[24 + l + 1] = (uint8_t)(crc >> 8);
        row[24 + l + 2] = (uint8_t)(crc >> 16);
        row[24 + l + 3] = (uint8_t)(crc >> 24);
    }
}

// Batched FCS check (decode_mac's CRC screen): mpdus (B, N) -> ok (B,).
void gwt_check_fcs_batch(const uint8_t* mpdus, int64_t b, int64_t n,
                         uint8_t* ok) {
    for (int64_t i = 0; i < b; ++i) {
        const uint8_t* row = mpdus + i * n;
        uint32_t crc = gwt_crc32(row, n - 4);
        uint32_t stored = (uint32_t)row[n - 4] | ((uint32_t)row[n - 3] << 8) |
                          ((uint32_t)row[n - 2] << 16) |
                          ((uint32_t)row[n - 1] << 24);
        ok[i] = crc == stored;
    }
}

// ---------------------------------------------------------------------------
// SPSC lock-free ring buffer over complex64 samples (8 bytes each) — the
// GNU Radio stream ring-buffer analogue. One producer thread (radio/UDP
// ingest) and one consumer thread (device feeder); head/tail are C++11
// atomics with acquire/release ordering, no locks on the data path.
// ---------------------------------------------------------------------------

struct GwtRing {
    std::vector<float> buf;          // 2 floats per sample (re, im)
    uint64_t capacity;               // samples, power of two
    uint64_t mask;
    std::atomic<uint64_t> head{0};   // total samples written
    std::atomic<uint64_t> tail{0};   // total samples read
};

void* gwt_ring_create(uint64_t capacity_samples) {
    uint64_t cap = 1;
    while (cap < capacity_samples) cap <<= 1;
    auto* r = new GwtRing();
    r->capacity = cap;
    r->mask = cap - 1;
    r->buf.resize(cap * 2);
    return r;
}

void gwt_ring_destroy(void* h) { delete (GwtRing*)h; }

uint64_t gwt_ring_capacity(void* h) { return ((GwtRing*)h)->capacity; }

uint64_t gwt_ring_available(void* h) {  // samples ready to read
    auto* r = (GwtRing*)h;
    return r->head.load(std::memory_order_acquire) -
           r->tail.load(std::memory_order_acquire);
}

uint64_t gwt_ring_space(void* h) {      // samples writable without overwrite
    auto* r = (GwtRing*)h;
    return r->capacity - gwt_ring_available(h);
}

// data: n samples as interleaved (re, im) float32. Returns samples written
// (may be < n when full — the caller decides whether to retry or drop, like
// GNU Radio backpressure).
uint64_t gwt_ring_write(void* h, const float* data, uint64_t n) {
    auto* r = (GwtRing*)h;
    uint64_t head = r->head.load(std::memory_order_relaxed);
    uint64_t tail = r->tail.load(std::memory_order_acquire);
    uint64_t space = r->capacity - (head - tail);
    if (n > space) n = space;
    for (uint64_t i = 0; i < n; ++i) {
        uint64_t idx = ((head + i) & r->mask) * 2;
        r->buf[idx] = data[2 * i];
        r->buf[idx + 1] = data[2 * i + 1];
    }
    r->head.store(head + n, std::memory_order_release);
    return n;
}

// out: capacity for n samples. Returns samples read (may be < n).
uint64_t gwt_ring_read(void* h, float* out, uint64_t n) {
    auto* r = (GwtRing*)h;
    uint64_t tail = r->tail.load(std::memory_order_relaxed);
    uint64_t head = r->head.load(std::memory_order_acquire);
    uint64_t avail = head - tail;
    if (n > avail) n = avail;
    for (uint64_t i = 0; i < n; ++i) {
        uint64_t idx = ((tail + i) & r->mask) * 2;
        out[2 * i] = r->buf[idx];
        out[2 * i + 1] = r->buf[idx + 1];
    }
    r->tail.store(tail + n, std::memory_order_release);
    return n;
}

// ---------------------------------------------------------------------------
// UDP PDU source/sink — the network.socket_pdu('UDP_SERVER', ...) analogue
// (IRS_user.grc:299-318). A dedicated C++ thread drains the socket into a
// bounded PDU queue; Python collects micro-batches without holding the GIL
// during recv.
// ---------------------------------------------------------------------------

struct GwtUdpSource {
    int fd = -1;
    int port = 0;
    size_t mtu;
    size_t max_queue;
    std::thread thr;
    std::atomic<bool> stop{false};
    std::mutex mu;
    std::condition_variable cv;
    std::deque<std::vector<uint8_t>> q;
    // each queued datagram's receive time, steady_clock (CLOCK_MONOTONIC) ns
    std::deque<int64_t> stamps;
    // datagrams the drop-oldest policy discarded
    std::atomic<int64_t> dropped{0};

    void run() {
        std::vector<uint8_t> buf(mtu);
        while (!stop.load(std::memory_order_relaxed)) {
            ssize_t n = recv(fd, buf.data(), buf.size(), 0);
            if (n < 0) continue;  // timeout or transient error
            if (n == 0) continue;
            int64_t t = std::chrono::duration_cast<std::chrono::nanoseconds>(
                std::chrono::steady_clock::now().time_since_epoch()).count();
            std::lock_guard<std::mutex> lk(mu);
            if (q.size() >= max_queue) {  // drop-oldest
                q.pop_front();
                stamps.pop_front();
                dropped.fetch_add(1, std::memory_order_relaxed);
            }
            q.emplace_back(buf.begin(), buf.begin() + n);
            stamps.push_back(t);
            cv.notify_one();
        }
    }
};

void* gwt_udp_source_create(const char* host, int port, int mtu,
                            int max_queue) {
    auto* s = new GwtUdpSource();
    s->mtu = (size_t)mtu;
    s->max_queue = (size_t)max_queue;
    s->fd = socket(AF_INET, SOCK_DGRAM, 0);
    if (s->fd < 0) { delete s; return nullptr; }
    int one = 1;
    setsockopt(s->fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    // deep kernel receive buffer (kernel caps at net.core.rmem_max):
    // bursty app-layer senders outpace the drain thread during device
    // dispatch; the default ~208 KiB holds only ~600 piece datagrams
    // and silently drops the rest of each burst
    int rcvbuf = 4 * 1024 * 1024;
    setsockopt(s->fd, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof(rcvbuf));
    struct timeval tv = {0, 200000};  // 200 ms poll so stop() is responsive
    setsockopt(s->fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)port);
    addr.sin_addr.s_addr = host && host[0] ? inet_addr(host) : INADDR_ANY;
    if (bind(s->fd, (sockaddr*)&addr, sizeof(addr)) != 0) {
        close(s->fd);
        delete s;
        return nullptr;
    }
    socklen_t alen = sizeof(addr);
    getsockname(s->fd, (sockaddr*)&addr, &alen);
    s->port = ntohs(addr.sin_port);
    s->thr = std::thread([s] { s->run(); });
    return s;
}

int gwt_udp_source_port(void* h) { return ((GwtUdpSource*)h)->port; }

// Drain up to max_pdus datagrams into a packed buffer: PDU payloads are laid
// back-to-back in `buf` (capacity buf_cap bytes); lens[i] gets each PDU's
// length and, where stamps_ns is not null, stamps_ns[i] its receive time
// (steady_clock ns, the clock of CLOCK_MONOTONIC). Blocks up to timeout_ms
// for the FIRST PDU, then returns whatever is queued (micro-batching
// semantics of runtime/bridge.py drain()).
int gwt_udp_source_drain(void* h, uint8_t* buf, int64_t buf_cap,
                         int32_t* lens, int64_t* stamps_ns,
                         int max_pdus, int timeout_ms) {
    auto* s = (GwtUdpSource*)h;
    std::unique_lock<std::mutex> lk(s->mu);
    if (s->q.empty() && timeout_ms > 0)
        s->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                       [s] { return !s->q.empty(); });
    int count = 0;
    int64_t used = 0;
    while (count < max_pdus && !s->q.empty()) {
        auto& pdu = s->q.front();
        if (used + (int64_t)pdu.size() > buf_cap) break;
        std::memcpy(buf + used, pdu.data(), pdu.size());
        lens[count] = (int32_t)pdu.size();
        if (stamps_ns) stamps_ns[count] = s->stamps.front();
        used += (int64_t)pdu.size();
        ++count;
        s->q.pop_front();
        s->stamps.pop_front();
    }
    return count;
}

// Datagrams discarded so far because the queue held max_queue.
int64_t gwt_udp_source_dropped(void* h) {
    return ((GwtUdpSource*)h)->dropped.load(std::memory_order_relaxed);
}

void gwt_udp_source_destroy(void* h) {
    auto* s = (GwtUdpSource*)h;
    s->stop.store(true);
    if (s->thr.joinable()) s->thr.join();
    if (s->fd >= 0) close(s->fd);
    delete s;
}

struct GwtUdpSink {
    int fd = -1;
    sockaddr_in addr{};
};

void* gwt_udp_sink_create(const char* host, int port) {
    auto* s = new GwtUdpSink();
    s->fd = socket(AF_INET, SOCK_DGRAM, 0);
    if (s->fd < 0) { delete s; return nullptr; }
    s->addr.sin_family = AF_INET;
    s->addr.sin_port = htons((uint16_t)port);
    s->addr.sin_addr.s_addr = inet_addr(host);
    return s;
}

int gwt_udp_sink_send(void* h, const uint8_t* data, int64_t n) {
    auto* s = (GwtUdpSink*)h;
    ssize_t sent = sendto(s->fd, data, (size_t)n, 0, (sockaddr*)&s->addr,
                          sizeof(s->addr));
    return sent == n ? 0 : -1;
}

void gwt_udp_sink_destroy(void* h) {
    auto* s = (GwtUdpSink*)h;
    if (s->fd >= 0) close(s->fd);
    delete s;
}

// ---------------------------------------------------------------------------
// Burst assembly (foo.packet_pad2 analogue, IRS_user.py:193-194): scatter a
// batch of TX bursts into one contiguous stream with pad_front/pad_tail
// spacing — the host-side hot loop when synthesizing long sample streams.
// bursts: (B, L) interleaved complex64 floats; out: n_out samples (zeroed
// here). positions: per-burst start sample.
// ---------------------------------------------------------------------------

void gwt_scatter_bursts(const float* bursts, int64_t b, int64_t l,
                        const int64_t* positions, float scale, float* out,
                        int64_t n_out) {
    std::memset(out, 0, sizeof(float) * 2 * (size_t)n_out);
    for (int64_t i = 0; i < b; ++i) {
        int64_t pos = positions[i];
        if (pos < 0) continue;
        int64_t count = l;
        if (pos + count > n_out) count = n_out - pos;
        const float* src = bursts + i * l * 2;
        float* dst = out + pos * 2;
        for (int64_t k = 0; k < count * 2; ++k) dst[k] += scale * src[k];
    }
}

}  // extern "C"
