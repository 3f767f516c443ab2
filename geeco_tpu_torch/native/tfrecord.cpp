// TFRecord SequenceExample writer: native encode + framing + zlib stream.
//
// The reference stores episodes as zlib-compressed TFRecord files of
// tf.train.SequenceExample protos (src/data/data_recorder.py:37-156).  This
// module reimplements that storage format from scratch — protobuf wire
// encoding, TFRecord length/CRC32C framing and the zlib stream — as a small
// C++ library driven through ctypes, so episode export (hundreds of MB of
// float image features per episode) runs at native speed off the device's
// hot path.  No TensorFlow involved.  The port's copy of
// geeco_tpu/native/tfrecord.cpp: the same bytes for the same records.
//
// Wire format facts used (stable, public):
//   Feature      { oneof kind { BytesList bytes_list = 1;
//                               FloatList float_list = 2;
//                               Int64List int64_list = 3; } }
//   BytesList    { repeated bytes value = 1; }
//   FloatList    { repeated float value = 1 [packed]; }
//   Int64List    { repeated int64 value = 1 [packed]; }
//   Features     { map<string, Feature> feature = 1; }
//   FeatureList  { repeated Feature feature = 1; }
//   FeatureLists { map<string, FeatureList> feature_list = 1; }
//   SequenceExample { Features context = 1; FeatureLists feature_lists = 2; }
//   TFRecord: uint64 len | uint32 masked_crc(len) | data |
//             uint32 masked_crc(data);  masked = ((c>>15|c<<17)+0xa282ead8)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

// ----------------------------------------------------------- crc32c

uint32_t crc32c_table[256];
bool crc32c_init_done = false;

void crc32c_init() {
  if (crc32c_init_done) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++)
      c = (c & 1) ? (0x82f63b78u ^ (c >> 1)) : (c >> 1);
    crc32c_table[i] = c;
  }
  crc32c_init_done = true;
}

uint32_t crc32c(const uint8_t* data, size_t n) {
  crc32c_init();
  uint32_t c = 0xffffffffu;
  for (size_t i = 0; i < n; i++)
    c = crc32c_table[(c ^ data[i]) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

uint32_t masked_crc(const uint8_t* data, size_t n) {
  uint32_t c = crc32c(data, n);
  return ((c >> 15) | (c << 17)) + 0xa282ead8u;
}

// ----------------------------------------------------------- protobuf

void put_varint(std::string* out, uint64_t v) {
  while (v >= 0x80) {
    out->push_back(static_cast<char>((v & 0x7f) | 0x80));
    v >>= 7;
  }
  out->push_back(static_cast<char>(v));
}

void put_tag(std::string* out, int field, int wire) {
  put_varint(out, (static_cast<uint64_t>(field) << 3) | wire);
}

void put_len_delim(std::string* out, int field, const std::string& payload) {
  put_tag(out, field, 2);
  put_varint(out, payload.size());
  out->append(payload);
}

void put_len_delim_raw(std::string* out, int field, const char* data,
                       size_t n) {
  put_tag(out, field, 2);
  put_varint(out, n);
  out->append(data, n);
}

// Feature with a packed FloatList.
std::string encode_float_feature(const float* vals, size_t n) {
  std::string packed(reinterpret_cast<const char*>(vals), n * 4);
  std::string float_list;
  put_len_delim_raw(&float_list, 1, packed.data(), packed.size());
  std::string feature;
  put_len_delim(&feature, 2, float_list);  // Feature.float_list = 2
  return feature;
}

std::string encode_int64_feature(const int64_t* vals, size_t n) {
  std::string packed;
  for (size_t i = 0; i < n; i++)
    put_varint(&packed, static_cast<uint64_t>(vals[i]));
  std::string int64_list;
  put_len_delim_raw(&int64_list, 1, packed.data(), packed.size());
  std::string feature;
  put_len_delim(&feature, 3, int64_list);  // Feature.int64_list = 3
  return feature;
}

std::string encode_bytes_feature(const char* data, size_t n) {
  std::string bytes_list;
  put_len_delim_raw(&bytes_list, 1, data, n);
  std::string feature;
  put_len_delim(&feature, 1, bytes_list);  // Feature.bytes_list = 1
  return feature;
}

// map<string, T> entry
std::string encode_map_entry(const char* key, const std::string& value) {
  std::string entry;
  put_len_delim_raw(&entry, 1, key, strlen(key));
  put_len_delim(&entry, 2, value);
  return entry;
}

// ----------------------------------------------------------- builder

struct ExampleBuilder {
  std::string context;        // serialized Features (concatenated entries)
  std::string feature_lists;  // serialized FeatureLists entries
};

struct Writer {
  gzFile gz = nullptr;        // zlib stream (gzip wrapper off: see open mode)
  FILE* raw = nullptr;
  z_stream zs;
  bool use_zlib = false;
  std::string pending;        // uncompressed framed records buffer

  ExampleBuilder builder;
};

void frame_record(std::string* out, const std::string& payload) {
  uint64_t len = payload.size();
  uint8_t len_bytes[8];
  memcpy(len_bytes, &len, 8);  // little-endian on x86
  uint32_t len_crc = masked_crc(len_bytes, 8);
  uint32_t data_crc = masked_crc(
      reinterpret_cast<const uint8_t*>(payload.data()), payload.size());
  out->append(reinterpret_cast<char*>(len_bytes), 8);
  out->append(reinterpret_cast<char*>(&len_crc), 4);
  out->append(payload);
  out->append(reinterpret_cast<char*>(&data_crc), 4);
}

}  // namespace

extern "C" {

// ---- writer lifecycle -----------------------------------------------

void* tfr_open(const char* path, int use_zlib) {
  Writer* w = new Writer();
  w->raw = fopen(path, "wb");
  if (!w->raw) { delete w; return nullptr; }
  w->use_zlib = use_zlib != 0;
  if (w->use_zlib) {
    memset(&w->zs, 0, sizeof(w->zs));
    // TFRecordWriter ZLIB uses a raw zlib stream (window bits 15)
    deflateInit2(&w->zs, Z_DEFAULT_COMPRESSION, Z_DEFLATED, 15, 8,
                 Z_DEFAULT_STRATEGY);
  }
  return w;
}

static void write_out(Writer* w, const char* data, size_t n, bool finish) {
  if (!w->use_zlib) {
    if (n) fwrite(data, 1, n, w->raw);
    return;
  }
  w->zs.next_in = reinterpret_cast<Bytef*>(const_cast<char*>(data));
  w->zs.avail_in = static_cast<uInt>(n);
  char buf[1 << 16];
  do {
    w->zs.next_out = reinterpret_cast<Bytef*>(buf);
    w->zs.avail_out = sizeof(buf);
    deflate(&w->zs, finish ? Z_FINISH : Z_NO_FLUSH);
    size_t have = sizeof(buf) - w->zs.avail_out;
    if (have) fwrite(buf, 1, have, w->raw);
  } while (w->zs.avail_out == 0);
}

int tfr_close(void* wp) {
  Writer* w = static_cast<Writer*>(wp);
  write_out(w, nullptr, 0, true);
  if (w->use_zlib) deflateEnd(&w->zs);
  int rc = fclose(w->raw);
  delete w;
  return rc;
}

// ---- example building ------------------------------------------------

void tfr_example_begin(void* wp) {
  Writer* w = static_cast<Writer*>(wp);
  w->builder.context.clear();
  w->builder.feature_lists.clear();
}

void tfr_context_floats(void* wp, const char* key, const float* vals,
                        int64_t n) {
  Writer* w = static_cast<Writer*>(wp);
  std::string entry = encode_map_entry(key, encode_float_feature(vals, n));
  put_len_delim(&w->builder.context, 1, entry);  // Features.feature = 1
}

void tfr_context_ints(void* wp, const char* key, const int64_t* vals,
                      int64_t n) {
  Writer* w = static_cast<Writer*>(wp);
  std::string entry = encode_map_entry(key, encode_int64_feature(vals, n));
  put_len_delim(&w->builder.context, 1, entry);
}

void tfr_context_bytes_list(void* wp, const char* key, const char** strs,
                            const int64_t* lens, int64_t count) {
  Writer* w = static_cast<Writer*>(wp);
  std::string bytes_list;
  for (int64_t i = 0; i < count; i++)
    put_len_delim_raw(&bytes_list, 1, strs[i], lens[i]);
  std::string feature;
  put_len_delim(&feature, 1, bytes_list);
  std::string entry = encode_map_entry(key, feature);
  put_len_delim(&w->builder.context, 1, entry);
}

// A float feature list: n_frames frames of frame_len floats each.
void tfr_featurelist_floats(void* wp, const char* key, const float* vals,
                            int64_t n_frames, int64_t frame_len) {
  Writer* w = static_cast<Writer*>(wp);
  std::string fl;
  for (int64_t t = 0; t < n_frames; t++) {
    std::string feature =
        encode_float_feature(vals + t * frame_len, frame_len);
    put_len_delim(&fl, 1, feature);  // FeatureList.feature = 1
  }
  std::string entry = encode_map_entry(key, fl);
  put_len_delim(&w->builder.feature_lists, 1, entry);
}

void tfr_featurelist_ints(void* wp, const char* key, const int64_t* vals,
                          int64_t n_frames, int64_t frame_len) {
  Writer* w = static_cast<Writer*>(wp);
  std::string fl;
  for (int64_t t = 0; t < n_frames; t++) {
    std::string feature =
        encode_int64_feature(vals + t * frame_len, frame_len);
    put_len_delim(&fl, 1, feature);
  }
  std::string entry = encode_map_entry(key, fl);
  put_len_delim(&w->builder.feature_lists, 1, entry);
}

void tfr_example_end(void* wp) {
  Writer* w = static_cast<Writer*>(wp);
  std::string example;
  put_len_delim(&example, 1, w->builder.context);        // context = 1
  put_len_delim(&example, 2, w->builder.feature_lists);  // lists = 2
  std::string framed;
  frame_record(&framed, example);
  write_out(w, framed.data(), framed.size(), false);
  w->builder.context.clear();
  w->builder.feature_lists.clear();
}

}  // extern "C"
