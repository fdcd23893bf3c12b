// senweaver-ctl — native job-control CLI for the trainer runtime.
//
// Role: the reference ships a 17.5k-LoC Rust `code-cli` (cli/src/) doing
// tunnels/auth/json_rpc/msgpack_rpc/singleton/self_update against its
// server. Rust is not in this image (SURVEY.md §2.6), so this is the C++
// equivalent scoped to the trainer, speaking to the Python control server
// (runtime/control.py of the Python package) over a unix domain socket:
//
//   - JSON-RPC 2.0 (default) and msgpack-RPC (--msgpack) framings
//     (cli/src/json_rpc.rs / msgpack_rpc.rs roles)
//   - auth tokens via --token-file or $SENWEAVER_CTL_TOKEN
//     (cli/src/auth.rs role; server enforces when configured)
//   - singleton lock via --singleton-lock PATH (flock; exit 3 when
//     another instance holds it — cli/src/singleton.rs role)
//   - watch: poll status until no job is queued/running
//   - tunnel: expose the unix-socket control plane on a loopback TCP
//     port (cli/src/tunnels.rs role, re-scoped: the reference tunnels
//     an IDE server to the vscode.dev relay; the trainer equivalent
//     forwards the coordinator's control socket so a remote operator —
//     e.g. over an SSH -L hop — can drive jobs)
//   - self-update: SHA-256-verified atomic in-place binary replacement
//     (cli/src/self_update.rs role, without the download half — the
//     candidate binary arrives by whatever channel ships checkpoints)
//
// Usage:
//   senweaver-ctl [opts] ping|status|watch|version
//   senweaver-ctl [opts] submit '<params-json>'
//   senweaver-ctl [opts] stop <job_id>
//   senweaver-ctl [opts] call <method> ['<params-json>']
//   senweaver-ctl [opts] tunnel <tcp-port>
//   senweaver-ctl [opts] self-update <new-binary>
//   opts: --socket PATH --token-file PATH --msgpack
//         --singleton-lock PATH --interval SECONDS
//         --accept-count N (tunnel: exit after N connections; 0 = forever)
//         --sha256 HEX --target PATH (self-update)
//
// Prints the JSON-RPC response (msgpack responses are re-rendered as
// JSON) to stdout; exit 0 on "result", 2 on "error", 1 on transport
// failure, 3 when the singleton lock is held elsewhere.

#include <cctype>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <poll.h>
#include <signal.h>
#include <sys/file.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/un.h>
#include <sys/wait.h>
#include <unistd.h>

namespace {

const char* kDefaultSocket = "/tmp/senweaver-ctl.sock";
const char* kVersion = "senweaver-ctl 2.1.0";

std::string json_escape(const std::string& s) {
  std::string out;
  out.reserve(s.size() + 8);
  for (char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      default:
        if ((unsigned char)c < 0x20) {
          char buf[8];
          std::snprintf(buf, sizeof buf, "\\u%04x", c);
          out += buf;
        } else {
          out += c;
        }
    }
  }
  return out;
}

bool looks_like_json(const std::string& s) {
  for (char c : s) {
    if (c == ' ' || c == '\t') continue;
    return c == '{' || c == '[' || c == '"' || (c >= '0' && c <= '9') ||
           c == 't' || c == 'f' || c == 'n' || c == '-';
  }
  return false;
}

// ---- msgpack encoding (request envelope: map of str → str|int) ----

void mp_str(std::string& out, const std::string& s) {
  size_t n = s.size();
  if (n < 32) {
    out += (char)(0xa0 | n);
  } else if (n < 0x100) {
    out += (char)0xd9;
    out += (char)n;
  } else if (n < 0x10000) {
    out += (char)0xda;
    out += (char)(n >> 8);
    out += (char)(n & 0xff);
  } else {            // str32: a 70 kB params blob must not truncate
    out += (char)0xdb;
    out += (char)((n >> 24) & 0xff);
    out += (char)((n >> 16) & 0xff);
    out += (char)((n >> 8) & 0xff);
    out += (char)(n & 0xff);
  }
  out += s;
}

// ---- msgpack decoding → JSON rendering (response path) ----

struct MpReader {
  const unsigned char* p;
  size_t len;
  size_t off = 0;
  bool ok = true;

  bool need(size_t n) {
    if (off + n > len) { ok = false; return false; }
    return true;
  }
  uint64_t be(size_t n) {
    uint64_t v = 0;
    for (size_t i = 0; i < n; i++) v = (v << 8) | p[off + i];
    off += n;
    return v;
  }
};

void mp_to_json(MpReader& r, std::string& out);

void mp_str_to_json(MpReader& r, size_t n, std::string& out) {
  if (!r.need(n)) return;
  out += '"';
  out += json_escape(std::string((const char*)r.p + r.off, n));
  out += '"';
  r.off += n;
}

void mp_seq_to_json(MpReader& r, size_t n, bool map, std::string& out) {
  out += map ? '{' : '[';
  for (size_t i = 0; i < n && r.ok; i++) {
    if (i) out += ", ";
    mp_to_json(r, out);
    if (map) {
      out += ": ";
      mp_to_json(r, out);
    }
  }
  out += map ? '}' : ']';
}

void mp_to_json(MpReader& r, std::string& out) {
  if (!r.need(1)) return;
  unsigned char b = r.p[r.off++];
  char buf[32];
  if (b <= 0x7f) {
    std::snprintf(buf, sizeof buf, "%u", b);
    out += buf;
  } else if (b >= 0xe0) {
    std::snprintf(buf, sizeof buf, "%d", (int)b - 256);
    out += buf;
  } else if (b >= 0x80 && b <= 0x8f) {
    mp_seq_to_json(r, b & 0x0f, true, out);
  } else if (b >= 0x90 && b <= 0x9f) {
    mp_seq_to_json(r, b & 0x0f, false, out);
  } else if (b >= 0xa0 && b <= 0xbf) {
    mp_str_to_json(r, b & 0x1f, out);
  } else if (b == 0xc0) {
    out += "null";
  } else if (b == 0xc2) {
    out += "false";
  } else if (b == 0xc3) {
    out += "true";
  } else if (b == 0xc4 || b == 0xc5 || b == 0xc6) {   // bin → str
    size_t w = (size_t)1 << (b - 0xc4);
    if (r.need(w)) mp_str_to_json(r, (size_t)r.be(w == 4 ? 4 : w), out);
  } else if (b == 0xcb) {                              // float64
    if (r.need(8)) {
      uint64_t bits = r.be(8);
      double d;
      std::memcpy(&d, &bits, 8);
      std::snprintf(buf, sizeof buf, "%.17g", d);
      out += buf;
    }
  } else if (b >= 0xcc && b <= 0xcf) {                 // uint
    size_t w = (size_t)1 << (b - 0xcc);
    if (r.need(w)) {
      std::snprintf(buf, sizeof buf, "%llu",
                    (unsigned long long)r.be(w));
      out += buf;
    }
  } else if (b >= 0xd0 && b <= 0xd3) {                 // int
    size_t w = (size_t)1 << (b - 0xd0);
    if (r.need(w)) {
      uint64_t raw = r.be(w);
      int64_t v;
      if (w == 1) v = (int8_t)raw;
      else if (w == 2) v = (int16_t)raw;
      else if (w == 4) v = (int32_t)raw;
      else v = (int64_t)raw;
      std::snprintf(buf, sizeof buf, "%lld", (long long)v);
      out += buf;
    }
  } else if (b == 0xd9 || b == 0xda || b == 0xdb) {    // str8/16/32
    size_t w = (size_t)1 << (b - 0xd9);
    if (r.need(w)) mp_str_to_json(r, (size_t)r.be(w), out);
  } else if (b == 0xdc || b == 0xdd) {                 // array16/32
    size_t w = b == 0xdc ? 2 : 4;
    if (r.need(w)) mp_seq_to_json(r, (size_t)r.be(w), false, out);
  } else if (b == 0xde || b == 0xdf) {                 // map16/32
    size_t w = b == 0xde ? 2 : 4;
    if (r.need(w)) mp_seq_to_json(r, (size_t)r.be(w), true, out);
  } else {
    r.ok = false;
  }
}

// ---- transport ----

int send_request(const char* socket_path, const std::string& request,
                 std::string& response) {
  int fd = ::socket(AF_UNIX, SOCK_STREAM, 0);
  if (fd < 0) {
    std::perror("socket");
    return 1;
  }
  sockaddr_un addr{};
  addr.sun_family = AF_UNIX;
  std::strncpy(addr.sun_path, socket_path, sizeof(addr.sun_path) - 1);
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof addr) != 0) {
    std::fprintf(stderr, "connect %s: %s\n", socket_path,
                 std::strerror(errno));
    ::close(fd);
    return 1;
  }
  size_t off = 0;
  while (off < request.size()) {
    ssize_t w = ::write(fd, request.data() + off, request.size() - off);
    if (w <= 0) {
      std::perror("write");
      ::close(fd);
      return 1;
    }
    off += (size_t)w;
  }
  ::shutdown(fd, SHUT_WR);
  char buf[4096];
  ssize_t r;
  while ((r = ::read(fd, buf, sizeof buf)) > 0)
    response.append(buf, (size_t)r);
  ::close(fd);
  return 0;
}

std::string read_token_file(const char* path) {
  FILE* f = std::fopen(path, "r");
  if (!f) {
    std::fprintf(stderr, "token file %s: %s\n", path, std::strerror(errno));
    std::exit(1);
  }
  char buf[512];
  size_t n = std::fread(buf, 1, sizeof buf - 1, f);
  std::fclose(f);
  buf[n] = 0;
  std::string tok(buf);
  while (!tok.empty() && (tok.back() == '\n' || tok.back() == '\r' ||
                          tok.back() == ' '))
    tok.pop_back();
  return tok;
}

std::string build_request(bool msgpack, const std::string& method,
                          const std::string& params_json,
                          const std::string& token) {
  if (!msgpack) {
    std::string req = std::string("{\"jsonrpc\": \"2.0\", \"id\": 1, ") +
                      "\"method\": \"" + json_escape(method) + "\"";
    if (!token.empty()) req += ", \"auth\": \"" + json_escape(token) + "\"";
    req += ", \"params\": " + params_json + "}\n";
    return req;
  }
  // msgpack envelope: map{jsonrpc, id, method, params_json[, auth]} —
  // params stay as embedded JSON text (argv already carries JSON); the
  // server inflates params_json (control.py _dispatch_msgpack).
  int n_keys = token.empty() ? 4 : 5;
  std::string out;
  out += (char)(0x80 | n_keys);
  mp_str(out, "jsonrpc");
  mp_str(out, "2.0");
  mp_str(out, "id");
  out += (char)1;                     // positive fixint 1
  mp_str(out, "method");
  mp_str(out, method);
  mp_str(out, "params_json");
  mp_str(out, params_json);
  if (!token.empty()) {
    mp_str(out, "auth");
    mp_str(out, token);
  }
  return out;
}

// ---- SHA-256 (FIPS 180-4; compact table-driven implementation) ----

struct Sha256 {
  uint32_t h[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                   0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
  unsigned char block[64];
  size_t fill = 0;
  uint64_t total = 0;

  static uint32_t rotr(uint32_t x, int n) {
    return (x >> n) | (x << (32 - n));
  }

  void compress(const unsigned char* p) {
    static const uint32_t K[64] = {
        0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b,
        0x59f111f1, 0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01,
        0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7,
        0xc19bf174, 0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
        0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da, 0x983e5152,
        0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
        0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc,
        0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
        0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819,
        0xd6990624, 0xf40e3585, 0x106aa070, 0x19a4c116, 0x1e376c08,
        0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f,
        0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
        0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
      w[i] = (uint32_t)p[4 * i] << 24 | (uint32_t)p[4 * i + 1] << 16 |
             (uint32_t)p[4 * i + 2] << 8 | p[4 * i + 3];
    for (int i = 16; i < 64; i++) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^
                    (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^
                    (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int i = 0; i < 64; i++) {
      uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + s1 + ch + K[i] + w[i];
      uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = s0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void update(const unsigned char* p, size_t n) {
    total += n;
    while (n > 0) {
      size_t take = 64 - fill < n ? 64 - fill : n;
      std::memcpy(block + fill, p, take);
      fill += take;
      p += take;
      n -= take;
      if (fill == 64) {
        compress(block);
        fill = 0;
      }
    }
  }

  std::string hexdigest() {
    uint64_t bits = total * 8;
    unsigned char pad = 0x80;
    update(&pad, 1);
    unsigned char zero = 0;
    while (fill != 56) update(&zero, 1);
    unsigned char len[8];
    for (int i = 0; i < 8; i++) len[i] = (unsigned char)(bits >> (56 - 8 * i));
    update(len, 8);
    char out[65];
    for (int i = 0; i < 8; i++)
      std::snprintf(out + 8 * i, 9, "%08x", h[i]);
    return std::string(out, 64);
  }
};

// ---- tunnel: loopback TCP port → unix-socket control plane ----

// Bidirectional byte relay with half-close propagation: the control
// protocol frames a request by shutdown(SHUT_WR), so EOF on one side
// must become SHUT_WR on the other (not a full close) or the server
// never sees end-of-request / the client never gets the response tail.
void relay(int a, int b) {
  bool a_open = true, b_open = true;
  char buf[1 << 16];
  while (a_open || b_open) {
    // Closed sides get fd=-1: poll() ignores negative fds, whereas
    // events=0 would still report POLLHUP and busy-spin the loop while
    // the other direction drains.
    pollfd fds[2] = {{a_open ? a : -1, POLLIN, 0},
                     {b_open ? b : -1, POLLIN, 0}};
    if (::poll(fds, 2, -1) < 0) {
      if (errno == EINTR) continue;
      return;
    }
    for (int i = 0; i < 2; i++) {
      if (!(fds[i].revents & (POLLIN | POLLHUP | POLLERR))) continue;
      int src = i == 0 ? a : b, dst = i == 0 ? b : a;
      ssize_t n = ::read(src, buf, sizeof buf);
      if (n <= 0) {
        ::shutdown(dst, SHUT_WR);
        (i == 0 ? a_open : b_open) = false;
        continue;
      }
      ssize_t off = 0;
      while (off < n) {
        ssize_t w = ::write(dst, buf + off, n - off);
        if (w <= 0) return;
        off += w;
      }
    }
  }
}

// JSON-RPC outcome: 0 = success envelope, 2 = error envelope (position
// comparison disambiguates payloads that merely CONTAIN the other key).
int response_exit_code(const std::string& response) {
  size_t err_pos = response.find("\"error\":");
  size_t res_pos = response.find("\"result\":");
  if (err_pos == std::string::npos) return 0;
  if (res_pos == std::string::npos) return 2;
  return err_pos < res_pos ? 2 : 0;
}

// ---- onboard: interactive first-run wizard over the control socket ----
// Drives services/onboarding.py's RPC channel (status/answer/skip): each
// pending step's prompt is printed, the operator's line is submitted as
// the answer (empty line = skip, valid only for optional steps), and
// validator rejections are shown and retried — the CLI face of the
// reference's onboarding surface.

// Position of the value after '"key":', tolerating any whitespace after
// the colon — a server-side switch to compact separators must not make
// field extraction (and the wizard's completion check) silently fail.
size_t json_value_pos(const std::string& body, const char* key) {
  std::string pat = std::string("\"") + key + "\":";
  size_t at = body.find(pat);
  if (at == std::string::npos) return std::string::npos;
  at += pat.size();
  while (at < body.size() &&
         (body[at] == ' ' || body[at] == '\t' || body[at] == '\n' ||
          body[at] == '\r'))
    at++;
  return at;
}

std::string extract_json_string(const std::string& body, const char* key) {
  size_t at = json_value_pos(body, key);
  if (at == std::string::npos || at >= body.size() || body[at] != '"')
    return "";
  at++;
  std::string out;
  while (at < body.size() && body[at] != '"') {
    char c = body[at++];
    if (c == '\\' && at < body.size()) {
      char e = body[at++];
      if (e == 'u' && at + 4 <= body.size()) {
        // \uXXXX: json.dumps(ensure_ascii=True) emits these for ANY
        // non-ASCII char — decode to UTF-8 instead of leaking 'uXXXX'
        unsigned cp = 0;
        bool okhex = true;
        for (int i = 0; i < 4; i++) {
          char h = body[at + i];
          cp <<= 4;
          if (h >= '0' && h <= '9') cp |= h - '0';
          else if (h >= 'a' && h <= 'f') cp |= h - 'a' + 10;
          else if (h >= 'A' && h <= 'F') cp |= h - 'A' + 10;
          else { okhex = false; break; }
        }
        if (okhex) {
          at += 4;
          if (cp >= 0xd800 && cp <= 0xdbff && at + 6 <= body.size() &&
              body[at] == '\\' && body[at + 1] == 'u') {
            // UTF-16 surrogate pair (astral chars, e.g. emoji): combine
            // into the supplementary code point; lone surrogates would
            // be CESU-8, not valid UTF-8
            unsigned lo = 0;
            bool lohex = true;
            for (int i = 0; i < 4; i++) {
              char h = body[at + 2 + i];
              lo <<= 4;
              if (h >= '0' && h <= '9') lo |= h - '0';
              else if (h >= 'a' && h <= 'f') lo |= h - 'a' + 10;
              else if (h >= 'A' && h <= 'F') lo |= h - 'A' + 10;
              else { lohex = false; break; }
            }
            if (lohex && lo >= 0xdc00 && lo <= 0xdfff) {
              at += 6;
              cp = 0x10000 + ((cp - 0xd800) << 10) + (lo - 0xdc00);
            }
          }
          if (cp < 0x80) {
            out += (char)cp;
          } else if (cp < 0x800) {
            out += (char)(0xc0 | (cp >> 6));
            out += (char)(0x80 | (cp & 0x3f));
          } else if (cp < 0x10000) {
            out += (char)(0xe0 | (cp >> 12));
            out += (char)(0x80 | ((cp >> 6) & 0x3f));
            out += (char)(0x80 | (cp & 0x3f));
          } else {
            out += (char)(0xf0 | (cp >> 18));
            out += (char)(0x80 | ((cp >> 12) & 0x3f));
            out += (char)(0x80 | ((cp >> 6) & 0x3f));
            out += (char)(0x80 | (cp & 0x3f));
          }
          continue;
        }
        c = e;               // malformed hex: keep the raw letter
      } else {
        switch (e) {
          case 'n': c = '\n'; break;
          case 't': c = '\t'; break;
          case 'r': c = '\r'; break;
          case 'b': c = '\b'; break;
          case 'f': c = '\f'; break;
          default: c = e; break;   // \" \\ \/
        }
      }
    }
    out += c;
  }
  return out;
}

int run_onboard(const char* socket_path, const std::string& token) {
  for (;;) {
    std::string resp;
    int rc = send_request(
        socket_path,
        build_request(false, "onboarding.status", "null", token), resp);
    if (rc != 0) return rc;
    if (response_exit_code(resp) != 0) {
      std::fprintf(stderr, "onboarding.status failed: %s\n", resp.c_str());
      return 1;
    }
    size_t done_at = json_value_pos(resp, "complete");
    if (done_at != std::string::npos &&
        resp.compare(done_at, 4, "true") == 0) {
      std::printf("onboarding complete\n");
      return 0;
    }
    std::string step = extract_json_string(resp, "current");
    std::string prompt = extract_json_string(resp, "prompt");
    if (step.empty()) {
      std::fprintf(stderr, "unexpected status payload: %s\n", resp.c_str());
      return 1;
    }
    std::fprintf(stderr, "[%s] %s\n> ", step.c_str(), prompt.c_str());
    std::fflush(stderr);
    char line[4096];
    if (!std::fgets(line, sizeof line, stdin)) {
      std::fprintf(stderr, "onboarding aborted (eof); progress saved\n");
      return 1;
    }
    std::string value = line;
    if (!value.empty() && value.back() != '\n' && !std::feof(stdin)) {
      // overlong line: drain the remainder so it cannot leak into the
      // NEXT step's answer, reject this one, re-prompt
      int ch;
      while ((ch = std::fgetc(stdin)) != EOF && ch != '\n') {}
      std::fprintf(stderr, "rejected: answer longer than %zu chars\n",
                   sizeof line - 2);
      continue;
    }
    while (!value.empty() &&
           (value.back() == '\n' || value.back() == '\r'))
      value.pop_back();
    std::string method = value.empty() ? "onboarding.skip"
                                       : "onboarding.answer";
    std::string params =
        std::string("{\"step\": \"") + json_escape(step) + "\"";
    if (!value.empty())
      params += ", \"value\": \"" + json_escape(value) + "\"";
    params += "}";
    resp.clear();     // send_request APPENDS; a stale "result" from the
                      // status read must not mask an error envelope
    rc = send_request(socket_path,
                      build_request(false, method, params, token), resp);
    if (rc != 0) return rc;
    if (response_exit_code(resp) != 0) {
      // validator rejection: show the message, re-prompt the same step
      std::string msg = extract_json_string(resp, "message");
      std::fprintf(stderr, "rejected: %s\n",
                   msg.empty() ? resp.c_str() : msg.c_str());
    }
  }
}

int run_tunnel(const char* socket_path, int port, long accept_count) {
  ::signal(SIGCHLD, SIG_IGN);  // auto-reap per-connection children
  ::signal(SIGPIPE, SIG_IGN);
  int lfd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (lfd < 0) {
    std::perror("socket");
    return 1;
  }
  int one = 1;
  ::setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);  // loopback ONLY: the
  addr.sin_port = htons((uint16_t)port);          // control plane is not
  if (::bind(lfd, (sockaddr*)&addr, sizeof addr) != 0) {  // for the LAN
    std::perror("bind");
    ::close(lfd);
    return 1;
  }
  if (::listen(lfd, 16) != 0) {
    std::perror("listen");
    ::close(lfd);
    return 1;
  }
  if (port == 0) {  // kernel-assigned: report it for the caller
    socklen_t alen = sizeof addr;
    ::getsockname(lfd, (sockaddr*)&addr, &alen);
    port = ntohs(addr.sin_port);
  }
  std::printf("tunnel listening on 127.0.0.1:%d -> %s\n", port, socket_path);
  std::fflush(stdout);

  for (long n = 0; accept_count == 0 || n < accept_count; n++) {
    int cfd = ::accept(lfd, nullptr, nullptr);
    if (cfd < 0) {
      // Transient accept errnos must not tear down a long-lived tunnel:
      // ECONNABORTED/EPROTO = the client reset before accept completed;
      // EMFILE/ENFILE = fd-limit burst, retry after the in-flight
      // children release theirs.
      if (errno == EINTR || errno == ECONNABORTED || errno == EPROTO) {
        n--;
        continue;
      }
      if (errno == EMFILE || errno == ENFILE) {
        std::fprintf(stderr, "tunnel: accept: %s; retrying\n",
                     std::strerror(errno));
        ::sleep(1);
        n--;
        continue;
      }
      std::perror("accept");
      ::close(lfd);
      return 1;
    }
    int ufd = ::socket(AF_UNIX, SOCK_STREAM, 0);
    sockaddr_un uaddr{};
    uaddr.sun_family = AF_UNIX;
    std::strncpy(uaddr.sun_path, socket_path, sizeof(uaddr.sun_path) - 1);
    if (ufd < 0 ||
        ::connect(ufd, (sockaddr*)&uaddr, sizeof uaddr) != 0) {
      std::fprintf(stderr, "tunnel: connect %s: %s\n", socket_path,
                   std::strerror(errno));
      if (ufd >= 0) ::close(ufd);
      ::close(cfd);
      continue;  // server may come back; keep the listener alive
    }
    pid_t pid = ::fork();
    if (pid == 0) {
      ::close(lfd);
      relay(cfd, ufd);
      ::close(cfd);
      ::close(ufd);
      ::_exit(0);
    }
    if (pid < 0) {
      // Out of processes: serve this connection inline rather than
      // silently dropping it (blocks the accept loop for its duration).
      std::fprintf(stderr, "tunnel: fork: %s; relaying inline\n",
                   std::strerror(errno));
      relay(cfd, ufd);
    }
    ::close(cfd);
    ::close(ufd);
  }
  ::close(lfd);
  return 0;
}

// ---- self-update: verified atomic binary replacement ----

int run_self_update(const char* new_binary, const char* sha256_hex,
                    const char* target_override) {
  std::string target;
  if (target_override) {
    target = target_override;
  } else {
    char buf[4096];
    ssize_t n = ::readlink("/proc/self/exe", buf, sizeof buf - 1);
    if (n <= 0) {
      std::perror("readlink /proc/self/exe");
      return 1;
    }
    buf[n] = 0;
    target = buf;
  }

  // Stage FIRST, then hash the staged copy: hashing the source and
  // copying it afterwards would verify bytes that a concurrent writer
  // could have swapped between the two reads (TOCTOU) — the checksum
  // must cover exactly what rename() installs. The staging file itself
  // must be unique+exclusive (mkstemp): a fixed predictable name would
  // let a concurrent writer interleave bytes into the very file being
  // hashed, reopening the same hole.
  std::string tmp = target + ".update.XXXXXX";
  std::vector<char> tmpl(tmp.begin(), tmp.end());
  tmpl.push_back(0);
  int dfd = ::mkstemp(tmpl.data());
  if (dfd < 0) {
    std::perror("self-update: mkstemp staging");
    return 1;
  }
  tmp.assign(tmpl.data());
  FILE* src = std::fopen(new_binary, "rb");
  if (!src) {
    std::perror("self-update: open source");
    ::close(dfd);
    ::unlink(tmp.c_str());
    return 1;
  }
  FILE* dst = ::fdopen(dfd, "wb");
  if (!dst) {
    std::perror("self-update: open staging");
    std::fclose(src);
    ::close(dfd);
    ::unlink(tmp.c_str());
    return 1;
  }
  char buf[1 << 16];
  size_t n;
  bool ok = true;
  int saved_errno = 0;  // errno at the FAILING call; later cleanup
                        // calls (fflush/fsync/fclose) overwrite errno
  Sha256 ctx;
  while ((n = std::fread(buf, 1, sizeof buf, src)) > 0) {
    if (std::fwrite(buf, 1, n, dst) != n) {
      saved_errno = errno;
      ok = false;
      break;
    }
    ctx.update((const unsigned char*)buf, n);
  }
  if (ok && std::ferror(src)) { saved_errno = errno; ok = false; }
  std::fclose(src);
  if (std::fflush(dst) != 0 && ok) { saved_errno = errno; ok = false; }
  if (::fsync(::fileno(dst)) != 0 && ok) { saved_errno = errno; ok = false; }
  std::fclose(dst);
  if (!ok) {
    std::fprintf(stderr, "self-update: staging %s failed: %s\n",
                 tmp.c_str(), std::strerror(saved_errno));
    ::unlink(tmp.c_str());
    return 1;
  }
  std::string actual = ctx.hexdigest();
  if (sha256_hex) {
    std::string expect(sha256_hex);
    for (auto& c : expect) c = (char)std::tolower((unsigned char)c);
    if (expect != actual) {
      std::fprintf(stderr,
                   "self-update: checksum mismatch\n  expect %s\n  actual "
                   "%s\n(target left untouched)\n",
                   expect.c_str(), actual.c_str());
      ::unlink(tmp.c_str());
      return 2;
    }
  } else {
    std::fprintf(stderr,
                 "self-update: warning: no --sha256 given — installing "
                 "UNVERIFIED binary (sha256 %s)\n",
                 actual.c_str());
  }
  if (::chmod(tmp.c_str(), 0755) != 0 ||
      ::rename(tmp.c_str(), target.c_str()) != 0) {
    std::fprintf(stderr, "self-update: installing %s failed: %s\n",
                 tmp.c_str(), std::strerror(errno));
    ::unlink(tmp.c_str());
    return 1;
  }
  std::printf("self-update: %s <- %s (sha256 %s)\n", target.c_str(),
              new_binary, actual.c_str());
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  const char* socket_path = kDefaultSocket;
  const char* token_file = nullptr;
  const char* singleton_lock = nullptr;
  const char* sha256_hex = nullptr;
  const char* update_target = nullptr;
  bool msgpack = false;
  int interval_s = 2;
  long accept_count = 0;
  int argi = 1;
  while (argi < argc && argv[argi][0] == '-') {
    if (argi + 1 < argc && std::strcmp(argv[argi], "--socket") == 0) {
      socket_path = argv[++argi];
    } else if (argi + 1 < argc &&
               std::strcmp(argv[argi], "--token-file") == 0) {
      token_file = argv[++argi];
    } else if (argi + 1 < argc &&
               std::strcmp(argv[argi], "--singleton-lock") == 0) {
      singleton_lock = argv[++argi];
    } else if (argi + 1 < argc &&
               std::strcmp(argv[argi], "--interval") == 0) {
      interval_s = std::atoi(argv[++argi]);
      if (interval_s < 1) interval_s = 1;
    } else if (argi + 1 < argc &&
               std::strcmp(argv[argi], "--accept-count") == 0) {
      accept_count = std::atol(argv[++argi]);
    } else if (argi + 1 < argc &&
               std::strcmp(argv[argi], "--sha256") == 0) {
      sha256_hex = argv[++argi];
    } else if (argi + 1 < argc &&
               std::strcmp(argv[argi], "--target") == 0) {
      update_target = argv[++argi];
    } else if (std::strcmp(argv[argi], "--msgpack") == 0) {
      msgpack = true;
    } else if (std::strcmp(argv[argi], "--version") == 0) {
      std::printf("%s\n", kVersion);
      return 0;
    } else {
      std::fprintf(stderr, "unknown option: %s\n", argv[argi]);
      return 1;
    }
    argi++;
  }
  if (argi >= argc) {
    std::fprintf(stderr,
                 "usage: senweaver-ctl [--socket PATH] [--token-file PATH] "
                 "[--msgpack] [--singleton-lock PATH] [--interval S] "
                 "[--accept-count N] [--sha256 HEX] [--target PATH] "
                 "<ping|status|watch|version|submit|stop|call|onboard|"
                 "tunnel|self-update> [args]\n");
    return 1;
  }

  // Singleton lock (cli/src/singleton.rs role): exclusive flock held for
  // the process lifetime; a second instance exits 3 immediately.
  if (singleton_lock) {
    int lfd = ::open(singleton_lock, O_CREAT | O_RDWR, 0644);
    if (lfd < 0) {
      std::perror("singleton lock open");
      return 1;
    }
    if (::flock(lfd, LOCK_EX | LOCK_NB) != 0) {
      std::fprintf(stderr,
                   "another senweaver-ctl holds the singleton lock %s\n",
                   singleton_lock);
      return 3;
    }
    // lfd intentionally stays open: the lock lives as long as we do.
  }

  std::string token;
  if (token_file) {
    token = read_token_file(token_file);
  } else if (const char* env = std::getenv("SENWEAVER_CTL_TOKEN")) {
    token = env;
  }

  std::string cmd = argv[argi++];
  if (cmd == "version") {
    std::printf("%s\n", kVersion);
    return 0;
  }
  if (cmd == "tunnel") {
    if (argi >= argc) {
      std::fprintf(stderr, "tunnel requires a TCP port (0 = auto)\n");
      return 1;
    }
    char* end = nullptr;
    long port = std::strtol(argv[argi], &end, 10);
    if (end == argv[argi] || *end != 0 || port < 0 || port > 65535) {
      std::fprintf(stderr, "tunnel: invalid port %s (need 0..65535)\n",
                   argv[argi]);
      return 1;
    }
    // The unix socket's file permissions gate the control plane; a
    // loopback TCP port has no ACL — every local uid can connect. The
    // tunnel is a dumb pipe (per-request auth stays with the server),
    // so surface the widened boundary when the server may be tokenless.
    if (token_file == nullptr &&
        std::getenv("SENWEAVER_CTL_TOKEN") == nullptr) {
      std::fprintf(stderr,
                   "tunnel: warning: no auth token configured here; "
                   "ensure the control server enforces one, or any "
                   "local user can reach it via this port\n");
    }
    return run_tunnel(socket_path, (int)port, accept_count);
  }
  if (cmd == "self-update") {
    if (argi >= argc) {
      std::fprintf(stderr, "self-update requires a new-binary path\n");
      return 1;
    }
    return run_self_update(argv[argi], sha256_hex, update_target);
  }
  if (cmd == "onboard") {
    if (msgpack)
      std::fprintf(stderr,
                   "onboard: interactive wizard uses JSON framing; "
                   "--msgpack ignored\n");
    return run_onboard(socket_path, token);
  }
  std::string method, params = "null";
  bool watch = false;
  if (cmd == "ping" || cmd == "status") {
    method = cmd;
  } else if (cmd == "watch") {
    method = "status";
    watch = true;
  } else if (cmd == "submit") {
    method = "submit";
    if (argi < argc) params = argv[argi++];
  } else if (cmd == "stop") {
    method = "stop";
    if (argi >= argc) {
      std::fprintf(stderr, "stop requires a job id\n");
      return 1;
    }
    params = std::string("{\"job_id\": \"") + json_escape(argv[argi++]) +
             "\"}";
  } else if (cmd == "call") {
    if (argi >= argc) {
      std::fprintf(stderr, "call requires a method name\n");
      return 1;
    }
    method = argv[argi++];
    if (argi < argc) params = argv[argi++];
  } else {
    std::fprintf(stderr, "unknown command: %s\n", cmd.c_str());
    return 1;
  }
  if (!looks_like_json(params)) {
    params = "\"" + json_escape(params) + "\"";
  }

  std::string request = build_request(msgpack, method, params, token);

  for (;;) {
    std::string response;
    int rc = send_request(socket_path, request, response);
    if (rc != 0) return rc;

    std::string rendered;
    if (msgpack) {
      MpReader r{(const unsigned char*)response.data(), response.size()};
      mp_to_json(r, rendered);
      if (!r.ok) {
        std::fprintf(stderr, "malformed msgpack response\n");
        return 1;
      }
    } else {
      rendered = response;
    }
    std::printf("%s\n", rendered.c_str());
    std::fflush(stdout);

    if (!watch) return response_exit_code(rendered);
    // watch: stop once no job is queued or running (or on RPC error).
    if (response_exit_code(rendered) != 0) return 2;
    if (rendered.find("\"queued\"") == std::string::npos &&
        rendered.find("\"running\"") == std::string::npos)
      return 0;
    ::sleep((unsigned)interval_s);
  }
}
