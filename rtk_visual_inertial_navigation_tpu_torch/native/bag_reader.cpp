// Native rosbag-2.0 reader / replay data-loader.
//
// The reference's L0 driver is a C++ rosbag replayer (rvi/main3.cpp:232-252:
// rosbag::View over the file, dispatching messages by topic in time order).
// This is its native equivalent for our runtime: parse the rosbag 2.0
// container (records with length-prefixed key=value headers; chunked with
// optional bz2 compression), index connections and message records, and
// expose the time-sorted stream to Python via ctypes with zero-copy access
// into the decompressed buffers.
//
// Message *bodies* (sensor_msgs/Imu etc.) are decoded on the Python side
// (io/reference_bag.py deserializers, tested) — this component owns the
// container parsing and decompression, the IO-bound part of replay.
//
// libbz2: the image ships the runtime .so but not bzlib.h; the one entry
// point we need is declared here and linked with -l:libbz2.so.1.0.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

extern "C" int BZ2_bzBuffToBuffDecompress(char* dest, unsigned int* destLen,
                                          char* source, unsigned int sourceLen,
                                          int small, int verbosity);

namespace {

constexpr char kMagic[] = "#ROSBAG V2.0\n";
constexpr size_t kMagicLen = sizeof(kMagic) - 1;

struct Field {
  const uint8_t* ptr;
  size_t len;
};

struct Header {
  // tiny fixed-capacity map (rosbag headers have <10 fields)
  static constexpr int kCap = 16;
  Field names[kCap];
  Field values[kCap];
  int n = 0;

  const Field* find(const char* name) const {
    const size_t ln = std::strlen(name);
    for (int i = 0; i < n; ++i) {
      if (names[i].len == ln && std::memcmp(names[i].ptr, name, ln) == 0)
        return &values[i];
    }
    return nullptr;
  }
};

bool parse_header(const uint8_t* buf, size_t len, Header* out) {
  size_t off = 0;
  out->n = 0;
  while (off + 4 <= len) {
    uint32_t flen;
    std::memcpy(&flen, buf + off, 4);
    off += 4;
    if (off + flen > len) return false;
    const uint8_t* field = buf + off;
    const uint8_t* eq =
        static_cast<const uint8_t*>(std::memchr(field, '=', flen));
    if (eq != nullptr && out->n < Header::kCap) {
      out->names[out->n] = {field, static_cast<size_t>(eq - field)};
      out->values[out->n] = {eq + 1, flen - (eq - field) - 1};
      ++out->n;
    }
    off += flen;
  }
  return true;
}

struct Msg {
  int topic_id;
  double t;
  const uint8_t* data;
  size_t len;
};

struct Bag {
  std::vector<uint8_t> file;
  std::vector<std::unique_ptr<std::vector<uint8_t>>> chunks;  // decompressed
  std::vector<std::string> topics;  // "topic\ttype" per connection id order
  std::vector<Msg> msgs;
  std::string error;
};

uint32_t rd_u32(const Field& f) {
  uint32_t v = 0;
  std::memcpy(&v, f.ptr, f.len < 4 ? f.len : 4);
  return v;
}

bool handle_records(Bag* bag, const uint8_t* buf, size_t len,
                    std::vector<int>* conn_map);

bool handle_one(Bag* bag, const Header& hdr, const uint8_t* data, size_t dlen,
                std::vector<int>* conn_map) {
  const Field* opf = hdr.find("op");
  const uint8_t op = (opf && opf->len >= 1) ? opf->ptr[0] : 0;
  if (op == 0x07) {  // connection record: map conn id -> topic/type
    const Field* connf = hdr.find("conn");
    const Field* topicf = hdr.find("topic");
    if (!connf || !topicf) return true;
    const uint32_t cid = rd_u32(*connf);
    Header sub;
    if (!parse_header(data, dlen, &sub)) return false;
    const Field* typef = sub.find("type");
    std::string entry(reinterpret_cast<const char*>(topicf->ptr),
                      topicf->len);
    entry += '\t';
    if (typef)
      entry.append(reinterpret_cast<const char*>(typef->ptr), typef->len);
    if (cid >= conn_map->size()) conn_map->resize(cid + 1, -1);
    if ((*conn_map)[cid] < 0) {
      (*conn_map)[cid] = static_cast<int>(bag->topics.size());
      bag->topics.push_back(std::move(entry));
    }
  } else if (op == 0x02) {  // message data
    const Field* connf = hdr.find("conn");
    const Field* timef = hdr.find("time");
    if (!connf || !timef || timef->len < 8) return true;
    const uint32_t cid = rd_u32(*connf);
    uint32_t sec, nsec;
    std::memcpy(&sec, timef->ptr, 4);
    std::memcpy(&nsec, timef->ptr + 4, 4);
    const int tid =
        (cid < conn_map->size()) ? (*conn_map)[cid] : -1;
    bag->msgs.push_back(
        {tid, sec + 1e-9 * nsec, data, dlen});
  } else if (op == 0x05) {  // chunk (none | bz2)
    const Field* compf = hdr.find("compression");
    const bool is_bz2 =
        compf && compf->len == 3 && std::memcmp(compf->ptr, "bz2", 3) == 0;
    const bool is_none =
        !compf || (compf->len == 4 && std::memcmp(compf->ptr, "none", 4) == 0);
    if (is_none) {
      return handle_records(bag, data, dlen, conn_map);
    }
    if (!is_bz2) {
      bag->error = "unsupported chunk compression (only none/bz2)";
      return false;
    }
    const Field* sizef = hdr.find("size");  // uncompressed size
    uint32_t usize = sizef ? rd_u32(*sizef) : 0;
    if (usize == 0) usize = static_cast<uint32_t>(dlen) * 12 + 4096;
    auto out = std::make_unique<std::vector<uint8_t>>(usize);
    unsigned int destLen = usize;
    const int rc = BZ2_bzBuffToBuffDecompress(
        reinterpret_cast<char*>(out->data()), &destLen,
        reinterpret_cast<char*>(const_cast<uint8_t*>(data)),
        static_cast<unsigned int>(dlen), 0, 0);
    if (rc != 0) {
      bag->error = "bz2 decompression failed (rc=" + std::to_string(rc) + ")";
      return false;
    }
    out->resize(destLen);
    const uint8_t* payload = out->data();
    const size_t plen = out->size();
    bag->chunks.push_back(std::move(out));
    return handle_records(bag, payload, plen, conn_map);
  }
  return true;  // index/chunk-info records are skipped
}

bool handle_records(Bag* bag, const uint8_t* buf, size_t len,
                    std::vector<int>* conn_map) {
  size_t off = 0;
  while (off + 8 <= len) {
    uint32_t hlen;
    std::memcpy(&hlen, buf + off, 4);
    off += 4;
    if (off + hlen + 4 > len) break;
    Header hdr;
    if (!parse_header(buf + off, hlen, &hdr)) return false;
    off += hlen;
    uint32_t dlen;
    std::memcpy(&dlen, buf + off, 4);
    off += 4;
    if (off + dlen > len) break;
    if (!handle_one(bag, hdr, buf + off, dlen, conn_map)) return false;
    off += dlen;
  }
  return true;
}

}  // namespace

extern "C" {

void* rvi_bag_open(const char* path) {
  auto bag = std::make_unique<Bag>();
  FILE* f = std::fopen(path, "rb");
  if (f == nullptr) {
    return nullptr;
  }
  std::fseek(f, 0, SEEK_END);
  const long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  bag->file.resize(n > 0 ? static_cast<size_t>(n) : 0);
  const size_t got = n > 0 ? std::fread(bag->file.data(), 1, n, f) : 0;
  std::fclose(f);
  if (got != bag->file.size() || bag->file.size() < kMagicLen ||
      std::memcmp(bag->file.data(), kMagic, kMagicLen) != 0) {
    return nullptr;
  }
  std::vector<int> conn_map;
  if (!handle_records(bag.get(), bag->file.data() + kMagicLen,
                      bag->file.size() - kMagicLen, &conn_map)) {
    return nullptr;
  }
  std::stable_sort(bag->msgs.begin(), bag->msgs.end(),
                   [](const Msg& a, const Msg& b) { return a.t < b.t; });
  return bag.release();
}

long long rvi_bag_count(void* h) {
  return static_cast<Bag*>(h)->msgs.size();
}

int rvi_bag_topic_count(void* h) {
  return static_cast<int>(static_cast<Bag*>(h)->topics.size());
}

int rvi_bag_topic_name(void* h, int tid, char* out, int cap) {
  const Bag* bag = static_cast<Bag*>(h);
  if (tid < 0 || tid >= static_cast<int>(bag->topics.size()) || cap <= 0)
    return -1;
  const std::string& s = bag->topics[tid];
  const int n = static_cast<int>(s.size()) < cap - 1
                    ? static_cast<int>(s.size())
                    : cap - 1;
  std::memcpy(out, s.data(), n);
  out[n] = '\0';
  return n;
}

int rvi_bag_msg(void* h, long long i, int* topic_id, double* t,
                const uint8_t** data, long long* len) {
  const Bag* bag = static_cast<Bag*>(h);
  if (i < 0 || i >= static_cast<long long>(bag->msgs.size())) return -1;
  const Msg& m = bag->msgs[i];
  *topic_id = m.topic_id;
  *t = m.t;
  *data = m.data;
  *len = static_cast<long long>(m.len);
  return 0;
}

void rvi_bag_close(void* h) { delete static_cast<Bag*>(h); }

}  // extern "C"
