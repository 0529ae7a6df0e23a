// Native HTTP serving front-end (L9 native tier).
//
// Role: the reference serves models behind native/JVM web frontends
// (OpenVINO JNI + Java POJO AbstractInferenceModel + Spring samples,
// SURVEY.md §2.8/§2.11.2). Here the socket/HTTP hot path is C++ — the
// Python side only sees (request bytes in, response bytes out) through
// a C ABI, so accept/parse/queue never touch the GIL while JAX runs.
//
// Protocol kept deliberately minimal and robust: HTTP/1.1,
// Connection: close per request, POST bodies up to a caller-set cap;
// GET /health answered entirely in C++ (no Python round trip).
//
// C ABI (ctypes-loaded by analytics_zoo_tpu.native):
//   zoo_http_create(port, max_body)  -> handle (0 on failure)
//   zoo_http_port(h)                 -> bound port
//   zoo_http_next(h, buf, cap, timeout_ms, &req_id, path, path_cap)
//       -> body length >=0, -1 timeout, -2 shutdown
//       (when the request carried an X-Zoo-Trace-Id header, the path
//        buffer holds "path\ntrace_id" — '\n' never appears in a
//        request line, and an old .so simply never emits it, so the
//        Python side degrades gracefully against a stale binary)
//   zoo_http_respond(h, req_id, status, body, len) -> 0 ok
//   zoo_http_respond_hdr(h, req_id, status, body, len, trace)
//       -> same, echoing trace as an X-Zoo-Trace-Id response header
//   zoo_http_set_health(h, json)     -> health payload
//   zoo_http_destroy(h)
#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>

namespace {

struct Request {
    long id;
    std::string path;
    std::string body;
    std::string trace;  // X-Zoo-Trace-Id header value ("" = none)
    int fd;
};

struct Server {
    int listen_fd = -1;
    int port = 0;
    long max_body = 16 * 1024 * 1024;
    std::atomic<bool> stop{false};
    std::atomic<int> conn_threads{0};
    std::thread acceptor;
    std::mutex mu;
    std::condition_variable cv;
    std::deque<Request> queue;
    // req_id -> (connection fd, response content-type code:
    // 0 = application/json, 1 = Prometheus text (GET /metrics),
    // 2 = text/html (GET /debug/dashboard))
    std::map<long, std::pair<int, int>> pending;
    long next_id = 1;
    std::string health = "{\"status\": \"ok\"}";
};

void write_all(int fd, const char* p, size_t n) {
    while (n > 0) {
        ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
        if (w <= 0) return;
        p += w;
        n -= static_cast<size_t>(w);
    }
}

void send_response(int fd, int status, const std::string& body,
                   const char* ctype = "application/json",
                   const std::string& extra_hdr = "") {
    const char* reason = status == 200 ? "OK" : status == 400
        ? "Bad Request" : status == 404 ? "Not Found"
        : status == 413 ? "Payload Too Large" : status == 503
        ? "Service Unavailable" : "Error";
    std::string head = "HTTP/1.1 " + std::to_string(status) + " " +
        reason + "\r\nContent-Type: " + ctype + "\r\n"
        "Content-Length: " + std::to_string(body.size()) +
        "\r\nConnection: close\r\n" + extra_hdr + "\r\n";
    write_all(fd, head.data(), head.size());
    write_all(fd, body.data(), body.size());
}

// wire-safe trace ids only (mirrors tracing.sanitize_trace_id): no
// header/log injection, bounded length
std::string sanitize_trace(const std::string& v) {
    std::string out;
    for (char c : v) {
        if ((c >= 'A' && c <= 'Z') || (c >= 'a' && c <= 'z') ||
            (c >= '0' && c <= '9') || c == '_' || c == '.' ||
            c == '-') {
            out.push_back(c);
            if (out.size() >= 64) break;
        } else if (c != ' ' && c != '\t') {
            return "";  // anything else: drop the header entirely
        }
    }
    return out;
}

// read one HTTP request (headers + Content-Length body); false = drop
bool read_request(Server* s, int fd, std::string* method,
                  std::string* path, std::string* body,
                  std::string* trace) {
    // overall deadline: SO_RCVTIMEO only bounds each recv, not a
    // slow-trickle client; destroy() relies on this hard cap
    const auto deadline = std::chrono::steady_clock::now() +
        std::chrono::seconds(60);
    std::string buf;
    char chunk[4096];
    size_t header_end = std::string::npos;
    while (header_end == std::string::npos) {
        if (std::chrono::steady_clock::now() > deadline) return false;
        ssize_t r = ::recv(fd, chunk, sizeof(chunk), 0);
        if (r <= 0) return false;
        buf.append(chunk, static_cast<size_t>(r));
        header_end = buf.find("\r\n\r\n");
        if (buf.size() > 64 * 1024 && header_end == std::string::npos)
            return false;  // header flood
    }
    std::string head = buf.substr(0, header_end);
    size_t sp1 = head.find(' ');
    size_t sp2 = head.find(' ', sp1 + 1);
    if (sp1 == std::string::npos || sp2 == std::string::npos)
        return false;
    *method = head.substr(0, sp1);
    *path = head.substr(sp1 + 1, sp2 - sp1 - 1);
    long content_len = 0;
    // case-insensitive Content-Length / X-Zoo-Trace-Id scan
    for (size_t pos = 0; (pos = head.find(':', pos)) !=
         std::string::npos; ++pos) {
        size_t ls = head.rfind('\n', pos);
        ls = ls == std::string::npos ? 0 : ls + 1;
        std::string name = head.substr(ls, pos - ls);
        for (auto& c : name) c = static_cast<char>(::tolower(c));
        if (name == "content-length") {
            content_len = ::atol(head.c_str() + pos + 1);
        } else if (name == "x-zoo-trace-id" && trace) {
            size_t ve = head.find('\r', pos);
            if (ve == std::string::npos) ve = head.find('\n', pos);
            if (ve == std::string::npos) ve = head.size();
            *trace = sanitize_trace(head.substr(pos + 1,
                                                ve - pos - 1));
        }
    }
    if (content_len < 0 || content_len > s->max_body) {
        send_response(fd, 413, "{\"error\": \"body too large\"}");
        return false;
    }
    *body = buf.substr(header_end + 4);
    while (static_cast<long>(body->size()) < content_len) {
        if (std::chrono::steady_clock::now() > deadline) return false;
        ssize_t r = ::recv(fd, chunk, sizeof(chunk), 0);
        if (r <= 0) return false;
        body->append(chunk, static_cast<size_t>(r));
    }
    body->resize(static_cast<size_t>(content_len));
    return true;
}

// per-connection: read + parse + enqueue off the acceptor thread, so
// one slow client cannot stall other connections or /health
void handle_conn(Server* s, int fd) {
    std::string method, path, body, trace;
    if (read_request(s, fd, &method, &path, &body, &trace)) {
        // GET /metrics[?...], /metrics/json and GET /debug/* ride
        // the worker queue: Python owns the metrics registry, the
        // trace store, and the fleet federation collector. The
        // pending code picks the response content-type: Prometheus
        // text for /metrics (with or without a ?fleet=1 query),
        // HTML for /debug/dashboard, JSON for everything else
        // including /metrics/json.
        bool is_json_metrics = method == "GET" &&
            (path == "/metrics/json" ||
             path.rfind("/metrics/json?", 0) == 0);
        bool is_metrics = method == "GET" && !is_json_metrics &&
            (path == "/metrics" ||
             path.rfind("/metrics?", 0) == 0);
        bool is_debug = method == "GET" &&
            path.rfind("/debug/", 0) == 0;
        bool is_dashboard = method == "GET" &&
            (path == "/debug/dashboard" ||
             path.rfind("/debug/dashboard?", 0) == 0);
        if (method == "GET" && path == "/health") {
            std::string payload;
            {
                std::lock_guard<std::mutex> g(s->mu);
                payload = s->health;
            }
            send_response(fd, 200, payload);
            ::close(fd);
        } else if (method != "POST" && !is_metrics &&
                   !is_json_metrics && !is_debug) {
            send_response(fd, 404, "{\"error\": \"POST only\"}");
            ::close(fd);
        } else {
            {
                std::lock_guard<std::mutex> g(s->mu);
                Request req;
                req.id = s->next_id++;
                req.path = path;
                req.body = std::move(body);
                req.trace = std::move(trace);
                req.fd = fd;
                s->pending[req.id] =
                    {fd, is_metrics ? 1 : (is_dashboard ? 2 : 0)};
                s->queue.push_back(std::move(req));
            }
            s->cv.notify_one();
        }
    } else {
        ::close(fd);
    }
    s->conn_threads.fetch_sub(1);
}

void accept_loop(Server* s) {
    while (!s->stop.load()) {
        sockaddr_in peer{};
        socklen_t len = sizeof(peer);
        int fd = ::accept(s->listen_fd,
                          reinterpret_cast<sockaddr*>(&peer), &len);
        if (fd < 0) {
            if (s->stop.load()) return;
            // e.g. EMFILE under fd exhaustion: don't busy-spin a core
            std::this_thread::sleep_for(std::chrono::milliseconds(10));
            continue;
        }
        int one = 1;
        ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        timeval tv{30, 0};  // bound slow/stuck clients
        ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
        ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
        s->conn_threads.fetch_add(1);
        try {
            std::thread(handle_conn, s, fd).detach();
        } catch (...) {  // thread spawn failure: shed the connection
            s->conn_threads.fetch_sub(1);
            send_response(fd, 503, "{\"error\": \"overloaded\"}");
            ::close(fd);
        }
    }
}

}  // namespace

extern "C" {

void* zoo_http_create(int port, long max_body) {
    auto* s = new Server();
    if (max_body > 0) s->max_body = max_body;
    s->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (s->listen_fd < 0) {
        delete s;
        return nullptr;
    }
    int one = 1;
    ::setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one,
                 sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (::bind(s->listen_fd, reinterpret_cast<sockaddr*>(&addr),
               sizeof(addr)) != 0 ||
        ::listen(s->listen_fd, 128) != 0) {
        ::close(s->listen_fd);
        delete s;
        return nullptr;
    }
    socklen_t alen = sizeof(addr);
    ::getsockname(s->listen_fd, reinterpret_cast<sockaddr*>(&addr),
                  &alen);
    s->port = ntohs(addr.sin_port);
    s->acceptor = std::thread(accept_loop, s);
    return s;
}

int zoo_http_port(void* h) {
    return h ? static_cast<Server*>(h)->port : -1;
}

void zoo_http_set_health(void* h, const char* json) {
    auto* s = static_cast<Server*>(h);
    std::lock_guard<std::mutex> g(s->mu);
    s->health = json ? json : "{}";
}

long zoo_http_next(void* h, char* buf, long cap, long timeout_ms,
                   long* req_id, char* path, long path_cap) {
    auto* s = static_cast<Server*>(h);
    std::unique_lock<std::mutex> g(s->mu);
    auto ready = [&] { return s->stop.load() || !s->queue.empty(); };
    if (timeout_ms < 0) {
        s->cv.wait(g, ready);
    } else if (!s->cv.wait_for(g, std::chrono::milliseconds(timeout_ms),
                               ready)) {
        return -1;
    }
    if (s->stop.load()) return -2;
    Request req = std::move(s->queue.front());
    s->queue.pop_front();
    if (static_cast<long>(req.body.size()) > cap) {
        // caller buffer too small — answer 503 here, skip the request
        s->pending.erase(req.id);
        g.unlock();
        send_response(req.fd, 503,
                      "{\"error\": \"server buffer too small\"}");
        ::close(req.fd);
        return -1;
    }
    std::memcpy(buf, req.body.data(), req.body.size());
    if (path_cap > 0) {
        // piggyback the trace id after the path ('\n' separated) so
        // the ABI stays stable — a trace id never fits worse than
        // the path alone did (path_cap is 1024, ids cap at 64)
        std::string out = req.path;
        if (!req.trace.empty()) out += "\n" + req.trace;
        long n = std::min<long>(path_cap - 1,
                                static_cast<long>(out.size()));
        std::memcpy(path, out.data(), static_cast<size_t>(n));
        path[n] = '\0';
    }
    *req_id = req.id;
    return static_cast<long>(req.body.size());
}

static int respond_impl(void* h, long req_id, int status,
                        const char* body, long len,
                        const char* trace) {
    auto* s = static_cast<Server*>(h);
    int fd = -1;
    int ctype_code = 0;
    {
        std::lock_guard<std::mutex> g(s->mu);
        auto it = s->pending.find(req_id);
        if (it == s->pending.end()) return -1;
        fd = it->second.first;
        ctype_code = it->second.second;
        s->pending.erase(it);
    }
    std::string extra;
    if (trace && *trace) {
        std::string t = sanitize_trace(trace);
        if (!t.empty()) extra = "X-Zoo-Trace-Id: " + t + "\r\n";
    }
    send_response(fd, status,
                  std::string(body, static_cast<size_t>(len)),
                  ctype_code == 1 ? "text/plain; version=0.0.4"
                  : ctype_code == 2 ? "text/html; charset=utf-8"
                  : "application/json",
                  extra);
    ::close(fd);
    return 0;
}

int zoo_http_respond(void* h, long req_id, int status,
                     const char* body, long len) {
    return respond_impl(h, req_id, status, body, len, nullptr);
}

int zoo_http_respond_hdr(void* h, long req_id, int status,
                         const char* body, long len,
                         const char* trace) {
    return respond_impl(h, req_id, status, body, len, trace);
}

void zoo_http_destroy(void* h) {
    auto* s = static_cast<Server*>(h);
    if (!s) return;
    s->stop.store(true);
    ::shutdown(s->listen_fd, SHUT_RDWR);
    ::close(s->listen_fd);
    s->cv.notify_all();
    if (s->acceptor.joinable()) s->acceptor.join();
    // connection threads are detached; worst-case lifetime is the 60s
    // read deadline + one 30s SO_RCVTIMEO recv. Wait past that; if a
    // thread is somehow still alive, deliberately LEAK the Server —
    // a one-off leak at shutdown beats a use-after-free.
    for (int i = 0; i < 95000 && s->conn_threads.load() > 0; ++i)
        std::this_thread::sleep_for(std::chrono::milliseconds(1));
    if (s->conn_threads.load() > 0) return;
    {
        std::lock_guard<std::mutex> g(s->mu);
        for (auto& kv : s->pending) ::close(kv.second.first);
    }
    delete s;
}

}  // extern "C"
