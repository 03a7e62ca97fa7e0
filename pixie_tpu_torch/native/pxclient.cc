// Native (C++) netbus client: execute PxL scripts against a deployed
// broker and print the result tables.
//
// Reference parity: the Go client library and CLI (src/api/go/pxapi
// client.go Client.ExecuteScript; src/pixie_cli): the reference ships
// native clients beside the Python API, and this is that surface for the
// port. It speaks the framed-TCP netbus of pixie_tpu_torch
// (services/netbus.py: a 4-byte LE length, then a frame in the versioned
// wire codec of services/wire.py), the bearer-token handshake included
// (services/auth.py sign_token: HMAC-SHA256 over a base64url JSON
// payload). The port's own copy: it reads result batches and --stream
// updates in the port's wire bytes, which equal the JAX package's.
//
// Build:  g++ -O3 -std=c++17 -pthread -o pxclient pxclient.cc
//         (pixie_tpu_torch.native.build_executable("pxclient") builds it
//         into pixie_tpu_torch/_build/ at first use)
// Usage:  pxclient [--host H] [--port P] [--secret S|--token T]
//                  [--timeout SEC] [--stream [--updates N]]
//                  (--pxl CODE | --script FILE | --list)
//
// --stream runs the query live (broker.execute_stream, the reference's
// StreamResults flow): updates print as they arrive, and after N
// updates (default 3) the client cancels server-side and exits.
//
// No dependencies beyond libc/libstdc++ (SHA-256 is implemented here so
// auth works without OpenSSL).

#include <arpa/inet.h>
#include <netdb.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cstdint>
#include <cstring>
#include <fstream>
#include <iostream>
#include <map>
#include <memory>
#include <random>
#include <sstream>
#include <stdexcept>
#include <string>
#include <vector>

// ---------------------------------------------------------------------------
// SHA-256 + HMAC (FIPS 180-4), for auth.py-compatible token signing.
// ---------------------------------------------------------------------------
namespace sha256 {

struct Ctx {
  uint32_t h[8];
  uint64_t len = 0;
  uint8_t buf[64];
  size_t buf_len = 0;
};

static const uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

static inline uint32_t rotr(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

static void init(Ctx* c) {
  static const uint32_t H0[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                 0xa54ff53a, 0x510e527f, 0x9b05688c,
                                 0x1f83d9ab, 0x5be0cd19};
  memcpy(c->h, H0, sizeof(H0));
  c->len = 0;
  c->buf_len = 0;
}

static void block(Ctx* c, const uint8_t* p) {
  uint32_t w[64];
  for (int i = 0; i < 16; i++)
    w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
           (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
  for (int i = 16; i < 64; i++) {
    uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
    uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  uint32_t a = c->h[0], b = c->h[1], cc = c->h[2], d = c->h[3], e = c->h[4],
           f = c->h[5], g = c->h[6], h = c->h[7];
  for (int i = 0; i < 64; i++) {
    uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = h + S1 + ch + K[i] + w[i];
    uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    uint32_t maj = (a & b) ^ (a & cc) ^ (b & cc);
    uint32_t t2 = S0 + maj;
    h = g; g = f; f = e; e = d + t1; d = cc; cc = b; b = a; a = t1 + t2;
  }
  c->h[0] += a; c->h[1] += b; c->h[2] += cc; c->h[3] += d;
  c->h[4] += e; c->h[5] += f; c->h[6] += g; c->h[7] += h;
}

static void update(Ctx* c, const void* data, size_t n) {
  const uint8_t* p = static_cast<const uint8_t*>(data);
  c->len += n;
  while (n > 0) {
    size_t take = std::min(n, sizeof(c->buf) - c->buf_len);
    memcpy(c->buf + c->buf_len, p, take);
    c->buf_len += take;
    p += take;
    n -= take;
    if (c->buf_len == 64) {
      block(c, c->buf);
      c->buf_len = 0;
    }
  }
}

static void final(Ctx* c, uint8_t out[32]) {
  uint64_t bits = c->len * 8;
  uint8_t pad = 0x80;
  update(c, &pad, 1);
  uint8_t zero = 0;
  while (c->buf_len != 56) update(c, &zero, 1);
  uint8_t lenb[8];
  for (int i = 0; i < 8; i++) lenb[i] = uint8_t(bits >> (56 - 8 * i));
  c->len -= 8;  // length bytes don't count
  update(c, lenb, 8);
  for (int i = 0; i < 8; i++) {
    out[4 * i] = uint8_t(c->h[i] >> 24);
    out[4 * i + 1] = uint8_t(c->h[i] >> 16);
    out[4 * i + 2] = uint8_t(c->h[i] >> 8);
    out[4 * i + 3] = uint8_t(c->h[i]);
  }
}

static void digest(const void* data, size_t n, uint8_t out[32]) {
  Ctx c;
  init(&c);
  update(&c, data, n);
  final(&c, out);
}

}  // namespace sha256

static std::string hmac_sha256_hex(const std::string& key,
                                   const std::string& msg) {
  uint8_t k[64] = {0};
  if (key.size() > 64) {
    sha256::digest(key.data(), key.size(), k);
  } else {
    memcpy(k, key.data(), key.size());
  }
  uint8_t ipad[64], opad[64];
  for (int i = 0; i < 64; i++) {
    ipad[i] = k[i] ^ 0x36;
    opad[i] = k[i] ^ 0x5c;
  }
  sha256::Ctx c;
  uint8_t inner[32], outer[32];
  sha256::init(&c);
  sha256::update(&c, ipad, 64);
  sha256::update(&c, msg.data(), msg.size());
  sha256::final(&c, inner);
  sha256::init(&c);
  sha256::update(&c, opad, 64);
  sha256::update(&c, inner, 32);
  sha256::final(&c, outer);
  static const char* hex = "0123456789abcdef";
  std::string out;
  for (int i = 0; i < 32; i++) {
    out += hex[outer[i] >> 4];
    out += hex[outer[i] & 15];
  }
  return out;
}

static std::string b64url_nopad(const std::string& in) {
  static const char* tbl =
      "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789-_";
  std::string out;
  size_t i = 0;
  while (i + 3 <= in.size()) {
    uint32_t v = (uint8_t(in[i]) << 16) | (uint8_t(in[i + 1]) << 8) |
                 uint8_t(in[i + 2]);
    out += tbl[(v >> 18) & 63];
    out += tbl[(v >> 12) & 63];
    out += tbl[(v >> 6) & 63];
    out += tbl[v & 63];
    i += 3;
  }
  size_t rem = in.size() - i;
  if (rem == 1) {
    uint32_t v = uint8_t(in[i]) << 16;
    out += tbl[(v >> 18) & 63];
    out += tbl[(v >> 12) & 63];
  } else if (rem == 2) {
    uint32_t v = (uint8_t(in[i]) << 16) | (uint8_t(in[i + 1]) << 8);
    out += tbl[(v >> 18) & 63];
    out += tbl[(v >> 12) & 63];
    out += tbl[(v >> 6) & 63];
  }
  return out;
}

// auth.py sign_token parity: base64url(JSON{sub,exp,claims}) + "." +
// HMAC-SHA256-hex. JSON must be compact + sort_keys to match the
// verifier's canonical form (it re-signs the body, so any valid JSON
// works — but keep the same shape for clarity).
static std::string sign_token(const std::string& secret,
                              const std::string& subject, double ttl_s) {
  double exp = double(time(nullptr)) + ttl_s;
  std::ostringstream js;
  js.precision(10);
  js << "{\"claims\":{},\"exp\":" << std::fixed << exp << ",\"sub\":\""
     << subject << "\"}";
  std::string body = b64url_nopad(js.str());
  return body + "." + hmac_sha256_hex(secret, body);
}

// ---------------------------------------------------------------------------
// Wire codec (services/wire.py v4): tag-prefixed recursive values.
// ---------------------------------------------------------------------------
struct Value;
using ValuePtr = std::shared_ptr<Value>;

struct NdArray {
  std::string dtype;  // numpy dtype.str, e.g. "<i8"
  bool scalar = false;
  std::vector<uint64_t> shape;
  std::string data;            // raw bytes (numeric)
  std::vector<ValuePtr> objs;  // object arrays ("G")
  bool is_object = false;
  size_t n_elems() const {
    size_t n = 1;
    for (auto d : shape) n *= d;
    return n;
  }
};

struct Value {
  enum Kind { NUL, BOOL, INT, BIGINT, REAL, STR, BYTES, ARR, LIST, MAP, ENUM,
              OBJ } kind = NUL;
  bool b = false;
  int64_t i = 0;
  double d = 0;
  std::string s;  // STR/BYTES/ENUM/BIGINT(decimal text)
  NdArray arr;
  std::vector<ValuePtr> list;  // LIST (and tuples)
  std::vector<std::pair<ValuePtr, ValuePtr>> map;
  uint16_t obj_tid = 0;
  ValuePtr obj_fields;  // MAP value

  const Value* get(const std::string& key) const {
    for (auto& kv : map)
      if (kv.first->kind == STR && kv.first->s == key) return kv.second.get();
    return nullptr;
  }
};

class Decoder {
 public:
  Decoder(const uint8_t* p, size_t n) : p_(p), n_(n) {}

  ValuePtr decode() {
    ValuePtr v = one();
    if (pos_ != n_) throw std::runtime_error("trailing bytes after value");
    return v;
  }

 private:
  const uint8_t* p_;
  size_t n_, pos_ = 0;

  uint8_t byte() {
    need(1);
    return p_[pos_++];
  }
  void need(size_t k) {
    if (pos_ + k > n_) throw std::runtime_error("wire truncated");
  }
  uint16_t u16() {
    need(2);
    uint16_t v;
    memcpy(&v, p_ + pos_, 2);
    pos_ += 2;
    return v;  // little-endian host assumed (x86/arm64)
  }
  uint32_t u32() {
    need(4);
    uint32_t v;
    memcpy(&v, p_ + pos_, 4);
    pos_ += 4;
    return v;
  }
  int64_t i64() {
    need(8);
    int64_t v;
    memcpy(&v, p_ + pos_, 8);
    pos_ += 8;
    return v;
  }
  double f64() {
    need(8);
    double v;
    memcpy(&v, p_ + pos_, 8);
    pos_ += 8;
    return v;
  }
  std::string bytes(size_t k) {
    need(k);
    std::string s(reinterpret_cast<const char*>(p_ + pos_), k);
    pos_ += k;
    return s;
  }

  ValuePtr one() {
    auto v = std::make_shared<Value>();
    uint8_t tag = byte();
    switch (tag) {
      case 'N': v->kind = Value::NUL; break;
      case 'T': v->kind = Value::BOOL; v->b = true; break;
      case 'F': v->kind = Value::BOOL; v->b = false; break;
      case 'I': v->kind = Value::INT; v->i = i64(); break;
      case 'J': v->kind = Value::BIGINT; v->s = bytes(u32()); break;
      case 'D': v->kind = Value::REAL; v->d = f64(); break;
      case 'S': v->kind = Value::STR; v->s = bytes(u32()); break;
      case 'B': v->kind = Value::BYTES; v->s = bytes(u32()); break;
      case 'E': v->kind = Value::ENUM; v->s = bytes(u16()); break;
      case 'A': {
        v->kind = Value::ARR;
        v->arr.dtype = bytes(u16());
        v->arr.scalar = byte() != 0;
        uint16_t nd = u16();
        for (int k = 0; k < nd; k++) v->arr.shape.push_back(u32());
        size_t itemsize = 0;
        // dtype.str: <i8 <f8 <u8(=uint64) |b1 <i4 <u4 <f4 |u1 <M8[ns] ...
        const std::string& dt = v->arr.dtype;
        if (dt.size() >= 3) {
          char num = dt[2];
          itemsize = (num >= '0' && num <= '9') ? size_t(num - '0') : 0;
        }
        if (itemsize == 0) throw std::runtime_error("bad dtype " + dt);
        v->arr.data = bytes(v->arr.n_elems() * itemsize);
        break;
      }
      case 'G': {
        v->kind = Value::ARR;
        v->arr.is_object = true;
        uint16_t nd = u16();
        for (int k = 0; k < nd; k++) v->arr.shape.push_back(u32());
        size_t n = v->arr.n_elems();
        for (size_t k = 0; k < n; k++) v->arr.objs.push_back(one());
        break;
      }
      case 'U':
      case 'L': {
        v->kind = Value::LIST;
        uint32_t n = u32();
        for (uint32_t k = 0; k < n; k++) v->list.push_back(one());
        break;
      }
      case 'M': {
        v->kind = Value::MAP;
        uint32_t n = u32();
        for (uint32_t k = 0; k < n; k++) {
          ValuePtr key = one();
          ValuePtr val = one();
          v->map.emplace_back(key, val);
        }
        break;
      }
      case 'O': {
        v->kind = Value::OBJ;
        v->obj_tid = u16();
        v->obj_fields = one();
        if (v->obj_fields->kind != Value::MAP)
          throw std::runtime_error("object fields not a map");
        break;
      }
      default:
        throw std::runtime_error("unknown wire tag " + std::to_string(tag));
    }
    return v;
  }
};

// Minimal encoder: exactly the shapes client requests need.
class Encoder {
 public:
  std::string out;
  void enc_str(const std::string& s) {
    out += 'S';
    u32(s.size());
    out += s;
  }
  void enc_int(int64_t v) {
    out += 'I';
    out.append(reinterpret_cast<const char*>(&v), 8);
  }
  void enc_real(double v) {
    out += 'D';
    out.append(reinterpret_cast<const char*>(&v), 8);
  }
  void map_header(uint32_t n) {
    out += 'M';
    u32(n);
  }

 private:
  void u32(uint32_t v) { out.append(reinterpret_cast<const char*>(&v), 4); }
};

// ---------------------------------------------------------------------------
// Framed-TCP netbus client (netbus.py parity).
// ---------------------------------------------------------------------------
static constexpr uint8_t WIRE_VERSION = 4;  // services/wire.py

class NetbusClient {
 public:
  NetbusClient(const std::string& host, int port, double timeout_s) {
    struct addrinfo hints = {}, *res = nullptr;
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    std::string port_s = std::to_string(port);
    if (getaddrinfo(host.c_str(), port_s.c_str(), &hints, &res) != 0 || !res)
      throw std::runtime_error("cannot resolve " + host);
    fd_ = socket(res->ai_family, res->ai_socktype, res->ai_protocol);
    if (fd_ < 0 || connect(fd_, res->ai_addr, res->ai_addrlen) != 0) {
      freeaddrinfo(res);
      throw std::runtime_error("cannot connect to " + host + ":" + port_s);
    }
    freeaddrinfo(res);
    struct timeval tv;
    tv.tv_sec = long(timeout_s);
    tv.tv_usec = long((timeout_s - double(tv.tv_sec)) * 1e6);
    setsockopt(fd_, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  }
  ~NetbusClient() {
    if (fd_ >= 0) close(fd_);
  }

  // payload = encoded VALUE; the codec prepends its version byte
  // (services/wire.py WIRE_VERSION).
  void send_frame(const std::string& value_bytes) {
    std::string payload;
    payload += char(WIRE_VERSION);
    payload += value_bytes;
    uint32_t len = payload.size();
    std::string frame(reinterpret_cast<const char*>(&len), 4);
    frame += payload;
    size_t off = 0;
    while (off < frame.size()) {
      ssize_t n = ::send(fd_, frame.data() + off, frame.size() - off, 0);
      if (n <= 0) throw std::runtime_error("send failed");
      off += size_t(n);
    }
  }

  ValuePtr recv_frame() {
    std::string hdr = recv_exact(4);
    uint32_t len;
    memcpy(&len, hdr.data(), 4);
    if (len > (1u << 30)) throw std::runtime_error("oversized frame");
    std::string payload = recv_exact(len);
    if (payload.empty() || uint8_t(payload[0]) != WIRE_VERSION)
      throw std::runtime_error("wire version mismatch");
    Decoder dec(reinterpret_cast<const uint8_t*>(payload.data()) + 1,
                payload.size() - 1);
    return dec.decode();
  }

  void auth(const std::string& token) {
    Encoder e;
    e.map_header(2);
    e.enc_str("op");
    e.enc_str("auth");
    e.enc_str("token");
    e.enc_str(token);
    send_frame(e.out);
    ValuePtr reply = recv_frame();
    const Value* op = reply->get("op");
    if (!op || op->s != "auth_ok") {
      const Value* err = reply->get("error");
      throw std::runtime_error("auth failed: " +
                               (err ? err->s : std::string("?")));
    }
  }

  void subscribe(const std::string& topic, int64_t sid) {
    Encoder e;
    e.map_header(3);
    e.enc_str("op");
    e.enc_str("sub");
    e.enc_str("topic");
    e.enc_str(topic);
    e.enc_str("sid");
    e.enc_int(sid);
    send_frame(e.out);
  }

  // Publish a {str: str|int|double} request with a _reply_to inbox.
  void publish_request(const std::string& topic,
                       const std::vector<std::pair<std::string, ValuePtr>>& kv,
                       const std::string& inbox) {
    Encoder msg;
    msg.map_header(kv.size() + 1);
    for (auto& [k, v] : kv) {
      msg.enc_str(k);
      switch (v->kind) {
        case Value::STR: msg.enc_str(v->s); break;
        case Value::INT: msg.enc_int(v->i); break;
        case Value::REAL: msg.enc_real(v->d); break;
        default: throw std::runtime_error("unsupported request value");
      }
    }
    msg.enc_str("_reply_to");
    msg.enc_str(inbox);
    Encoder e;
    e.map_header(3);
    e.enc_str("op");
    e.enc_str("pub");
    e.enc_str("topic");
    e.enc_str(topic);
    e.enc_str("msg");
    e.out += msg.out;
    send_frame(e.out);
  }

  // Wait for the op=="msg" frame carrying our sid.
  ValuePtr wait_reply(int64_t sid) {
    for (;;) {
      ValuePtr f = recv_frame();
      const Value* op = f->get("op");
      const Value* fsid = f->get("sid");
      if (op && op->kind == Value::STR && op->s == "msg" && fsid &&
          fsid->i == sid) {
        for (auto& kv : f->map)
          if (kv.first->s == "msg") return kv.second;
      }
    }
  }

 private:
  int fd_ = -1;
  std::string recv_exact(size_t n) {
    std::string buf;
    buf.resize(n);
    size_t off = 0;
    while (off < n) {
      ssize_t k = ::recv(fd_, buf.data() + off, n - off, 0);
      if (k <= 0) throw std::runtime_error("connection closed/timeout");
      off += size_t(k);
    }
    return buf;
  }
};

// ---------------------------------------------------------------------------
// Result printing: HostBatch (wire type id 2; Relation=0, StringDict=1 —
// the _registered_types order in services/wire.py).
// ---------------------------------------------------------------------------
static constexpr uint16_t TID_RELATION = 0;
static constexpr uint16_t TID_STRINGDICT = 1;
static constexpr uint16_t TID_HOSTBATCH = 2;

template <typename T>
static T elem(const NdArray& a, size_t i) {
  T v;
  memcpy(&v, a.data.data() + i * sizeof(T), sizeof(T));
  return v;
}

static void print_batch(const std::string& name, const Value& hb) {
  if (hb.kind != Value::OBJ || hb.obj_tid != TID_HOSTBATCH) {
    std::cout << "[" << name << "] <unexpected payload>\n";
    return;
  }
  const Value& f = *hb.obj_fields;
  const Value* rel = f.get("relation");
  const Value* cols = f.get("cols");
  const Value* dicts = f.get("dicts");
  const Value* len_v = f.get("length");
  if (!rel || !cols || !len_v || rel->kind != Value::OBJ ||
      rel->obj_tid != TID_RELATION) {
    std::cout << "[" << name << "] <malformed batch>\n";
    return;
  }
  int64_t n = len_v->i;
  // relation items: [(name, dtype-string), ...]
  std::vector<std::pair<std::string, std::string>> schema;
  const Value* items = rel->obj_fields->get("items");
  for (auto& it : items->list)
    schema.emplace_back(it->list[0]->s, it->list[1]->s);
  // per-column dictionaries
  std::map<std::string, const Value*> dict_of;
  if (dicts && dicts->kind == Value::MAP)
    for (auto& kv : dicts->map)
      if (kv.second->kind == Value::OBJ &&
          kv.second->obj_tid == TID_STRINGDICT)
        dict_of[kv.first->s] = kv.second.get();

  std::cout << "[" << name << "] " << n << " rows\n";
  for (auto& [cn, ct] : schema) std::cout << cn << "\t";
  std::cout << "\n";
  // Hoist per-column plane + dictionary resolution out of the row loop
  // (the cols map is linear-scan; doing it per cell is O(rows*cols^2)).
  struct Col {
    std::string type;
    const Value* planes = nullptr;
    const Value* strs = nullptr;  // dictionary strings list
  };
  std::vector<Col> cs;
  for (auto& [cn, ct] : schema) {
    Col c;
    c.type = ct;
    for (auto& kv : cols->map)
      if (kv.first->s == cn) c.planes = kv.second.get();
    if (c.planes && c.planes->list.empty()) c.planes = nullptr;
    auto it = dict_of.find(cn);
    if (it != dict_of.end()) c.strs = it->second->obj_fields->get("strings");
    cs.push_back(c);
  }
  for (int64_t r = 0; r < n; r++) {
    for (auto& c : cs) {
      if (!c.planes) {
        std::cout << "?\t";
        continue;
      }
      const NdArray& p0 = c.planes->list[0]->arr;
      if (c.type == "string") {
        if (p0.is_object) {  // already-decoded object column
          std::cout << p0.objs[r]->s << "\t";
        } else {
          int32_t id = elem<int32_t>(p0, r);
          if (c.strs && id >= 0 && size_t(id) < c.strs->list.size())
            std::cout << c.strs->list[id]->s << "\t";
          else
            std::cout << "<" << id << ">\t";
        }
      } else if (c.type == "uint128") {
        uint64_t hi = elem<uint64_t>(p0, r);
        uint64_t lo = elem<uint64_t>(c.planes->list[1]->arr, r);
        // UPID display form asid:pid:start (utils/upid.py layout)
        std::cout << (hi >> 32) << ":" << (hi & 0xffffffffu) << ":" << lo
                  << "\t";
      } else if (c.type == "float64") {
        std::cout << elem<double>(p0, r) << "\t";
      } else if (c.type == "boolean") {
        std::cout << (p0.data[r] ? "true" : "false") << "\t";
      } else {  // int64 / time64ns
        std::cout << elem<int64_t>(p0, r) << "\t";
      }
    }
    std::cout << "\n";
  }
}

// ---------------------------------------------------------------------------
int main(int argc, char** argv) {
  std::string host = "127.0.0.1", secret, token, pxl, script_path;
  int port = 6100;
  double timeout_s = 30.0;
  bool do_list = false, do_stream = false;
  int max_updates = 3;
  try {
    for (int i = 1; i < argc; i++) {
      std::string a = argv[i];
      auto next = [&]() -> std::string {
        if (i + 1 >= argc) throw std::runtime_error("missing value for " + a);
        return argv[++i];
      };
      if (a == "--host") host = next();
      else if (a == "--port") port = std::stoi(next());
      else if (a == "--secret") secret = next();
      else if (a == "--token") token = next();
      else if (a == "--timeout") timeout_s = std::stod(next());
      else if (a == "--pxl") pxl = next();
      else if (a == "--script") script_path = next();
      else if (a == "--list") do_list = true;
      else if (a == "--stream") do_stream = true;
      else if (a == "--updates") max_updates = std::stoi(next());
      else throw std::runtime_error("unknown arg: " + a);
    }
  } catch (const std::exception& e) {
    std::cerr << "pxclient: " << e.what() << "\n";
    return 2;
  }
  if (!script_path.empty()) {
    std::ifstream f(script_path);
    if (!f) {
      std::cerr << "cannot read " << script_path << "\n";
      return 2;
    }
    std::stringstream ss;
    ss << f.rdbuf();
    pxl = ss.str();
  }
  if (pxl.empty() && !do_list) {
    std::cerr << "usage: pxclient [--host H] [--port P] [--secret S|"
                 "--token T] [--timeout SEC] [--stream [--updates N]] "
                 "(--pxl CODE | --script FILE | --list)\n";
    return 2;
  }

  try {
    NetbusClient bus(host, port, timeout_s + 5.0);
    if (!secret.empty() && token.empty())
      token = sign_token(secret, "pxclient", 3600.0);
    if (!token.empty()) bus.auth(token);

    std::random_device rd;
    std::ostringstream inbox;
    inbox << "_inbox.native." << std::hex << rd() << rd();
    bus.subscribe(inbox.str(), 1);

    std::vector<std::pair<std::string, ValuePtr>> req;
    auto sv = [](const std::string& s) {
      auto v = std::make_shared<Value>();
      v->kind = Value::STR;
      v->s = s;
      return v;
    };
    auto dv = [](double d) {
      auto v = std::make_shared<Value>();
      v->kind = Value::REAL;
      v->d = d;
      return v;
    };
    if (do_stream && !do_list) {
      // Live query (broker.execute_stream): updates arrive on a
      // client-chosen topic as {table, batch, seq, mode} messages.
      std::ostringstream up;
      up << "client.stream.native." << std::hex << rd();
      bus.subscribe(up.str(), 2);
      req.emplace_back("query", sv(pxl));
      req.emplace_back("update_topic", sv(up.str()));
      req.emplace_back("poll_interval_s", dv(0.25));
      if (!token.empty()) req.emplace_back("token", sv(token));
      bus.publish_request("broker.execute_stream", req, inbox.str());
      std::string qid;
      bool have_reply = false;
      int updates = 0;
      while (!have_reply || updates < max_updates) {
        ValuePtr f = bus.recv_frame();
        const Value* op = f->get("op");
        if (!op || op->kind != Value::STR || op->s != "msg") continue;
        const Value* fsid = f->get("sid");
        const Value* msg = nullptr;
        for (auto& kv : f->map)
          if (kv.first->s == "msg") msg = kv.second.get();
        if (!msg) continue;
        if (fsid && fsid->i == 1) {
          const Value* ok2 = msg->get("ok");
          if (!ok2 || ok2->kind != Value::BOOL || !ok2->b) {
            const Value* err = msg->get("error");
            std::cerr << "error: " << (err ? err->s : "unknown") << "\n";
            return 1;
          }
          const Value* q = msg->get("qid");
          if (q) qid = q->s;
          have_reply = true;
        } else if (fsid && fsid->i == 2) {
          const Value* err = msg->get("error");
          if (err) {
            std::cerr << "stream error: " << err->s << "\n";
            return 1;
          }
          const Value* tbl = msg->get("table");
          const Value* seq = msg->get("seq");
          const Value* mode = msg->get("mode");
          std::cout << "-- update seq=" << (seq ? seq->i : -1) << " mode="
                    << (mode ? mode->s : "?") << "\n";
          for (auto& kv : msg->map)
            if (kv.first->s == "batch")
              print_batch(tbl ? tbl->s : "?", *kv.second);
          updates++;
        }
      }
      if (!qid.empty()) {
        std::vector<std::pair<std::string, ValuePtr>> c;
        c.emplace_back("qid", sv(qid));
        if (!token.empty()) c.emplace_back("token", sv(token));
        bus.publish_request("broker.stream_cancel", c, inbox.str());
        bus.wait_reply(1);
      }
      return 0;
    }
    std::string topic;
    if (do_list) {
      topic = "broker.scripts";
    } else {
      topic = "broker.execute";
      req.emplace_back("query", sv(pxl));
      req.emplace_back("timeout_s", dv(timeout_s));
    }
    if (!token.empty()) req.emplace_back("token", sv(token));
    bus.publish_request(topic, req, inbox.str());
    ValuePtr res = bus.wait_reply(1);

    const Value* ok = res->get("ok");
    if (!ok || ok->kind != Value::BOOL || !ok->b) {
      const Value* err = res->get("error");
      std::cerr << "error: " << (err ? err->s : "unknown") << "\n";
      return 1;
    }
    if (do_list) {
      const Value* scripts = res->get("scripts");
      if (scripts)
        for (auto& s : scripts->list) std::cout << s->s << "\n";
      return 0;
    }
    const Value* tables = res->get("tables");
    if (!tables || tables->kind != Value::MAP) {
      std::cerr << "error: reply carries no tables\n";
      return 1;
    }
    for (auto& kv : tables->map) print_batch(kv.first->s, *kv.second);
    return 0;
  } catch (const std::exception& e) {
    std::cerr << "pxclient: " << e.what() << "\n";
    return 1;
  }
}
