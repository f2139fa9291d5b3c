// Native IO for seqrec_tpu_torch: fast parsers for the dataset contract.
//
// The port's own copy of the JAX package's parser
// (seqrec_tpu/native_src/seqrec_io.cc), so that the port imports and
// builds nothing of that package. The reference parses its text formats
// line by line in Python on every load (the reference's
// helpers/data_handling.py:112-124); these parsers read the whole file once
// and emit the packed arrays the port uses directly
// (seqrec_tpu_torch/data/dataset.py SequenceStore). Exposed through a
// minimal C ABI consumed via ctypes (seqrec_tpu_torch/data/native.py).
//
// Formats parsed:
//   *_set_sequences : line = "user i1 r1 i2 r2 ..." (whitespace separated)
//   *_set_triplets  : line = "user\titem\trating"

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Read an entire file into a NUL-terminated buffer. Returns nullptr on error.
char* read_file(const char* path, size_t* size_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  if (size < 0) {
    std::fclose(f);
    return nullptr;
  }
  std::fseek(f, 0, SEEK_SET);
  char* buf = static_cast<char*>(std::malloc(static_cast<size_t>(size) + 1));
  if (!buf) {
    std::fclose(f);
    return nullptr;
  }
  size_t got = std::fread(buf, 1, static_cast<size_t>(size), f);
  std::fclose(f);
  buf[got] = '\0';
  *size_out = got;
  return buf;
}

inline void skip_ws(const char*& p) {
  while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
}

// Parse a (possibly negative, possibly fractional) number fast.
// Integer ids in the datasets are plain digit runs; ratings may have one
// fractional part. strtod handles stragglers (e.g. "3e0").
inline double parse_number(const char*& p) {
  skip_ws(p);
  const char* start = p;
  bool neg = false;
  if (*p == '-') {
    neg = true;
    ++p;
  }
  int64_t intpart = 0;
  bool any = false;
  while (*p >= '0' && *p <= '9') {
    intpart = intpart * 10 + (*p - '0');
    ++p;
    any = true;
  }
  double val = static_cast<double>(intpart);
  if (*p == '.') {
    ++p;
    double frac = 0, scale = 1;
    while (*p >= '0' && *p <= '9') {
      frac = frac * 10 + (*p - '0');
      scale *= 10;
      ++p;
    }
    val += frac / scale;
  } else if (!any || *p == 'e' || *p == 'E') {
    // fall back for exotic formats
    char* end = nullptr;
    val = std::strtod(start, &end);
    p = end;
    return val;
  }
  return neg ? -val : val;
}

}  // namespace

extern "C" {

struct SeqData {
  int32_t* items;
  float* ratings;
  int64_t* offsets;  // n_seq + 1 entries
  int64_t* users;
  int64_t n_seq;
  int64_t n_interactions;
};

// Parse a *_set_sequences file. Returns nullptr on IO error.
SeqData* seqrec_load_sequences(const char* path) {
  size_t size = 0;
  char* buf = read_file(path, &size);
  if (!buf) return nullptr;

  std::vector<int32_t> items;
  std::vector<float> ratings;
  std::vector<int64_t> offsets;
  std::vector<int64_t> users;
  items.reserve(size / 8);
  ratings.reserve(size / 8);
  offsets.push_back(0);

  const char* p = buf;
  const char* end = buf + size;
  while (p < end) {
    skip_ws(p);
    if (*p == '\n') {
      ++p;
      continue;
    }
    if (p >= end || *p == '\0') break;
    users.push_back(static_cast<int64_t>(parse_number(p)));
    while (true) {
      skip_ws(p);
      if (p >= end || *p == '\n' || *p == '\0') break;
      int32_t item = static_cast<int32_t>(parse_number(p));
      skip_ws(p);
      float rating = 1.0f;
      if (p < end && *p != '\n' && *p != '\0') {
        rating = static_cast<float>(parse_number(p));
      }
      items.push_back(item);
      ratings.push_back(rating);
    }
    offsets.push_back(static_cast<int64_t>(items.size()));
    if (p < end && *p == '\n') ++p;
  }
  std::free(buf);

  SeqData* out = static_cast<SeqData*>(std::malloc(sizeof(SeqData)));
  out->n_seq = static_cast<int64_t>(users.size());
  out->n_interactions = static_cast<int64_t>(items.size());
  out->items = static_cast<int32_t*>(std::malloc(items.size() * sizeof(int32_t)));
  out->ratings = static_cast<float*>(std::malloc(ratings.size() * sizeof(float)));
  out->offsets =
      static_cast<int64_t*>(std::malloc(offsets.size() * sizeof(int64_t)));
  out->users = static_cast<int64_t*>(std::malloc(users.size() * sizeof(int64_t)));
  std::memcpy(out->items, items.data(), items.size() * sizeof(int32_t));
  std::memcpy(out->ratings, ratings.data(), ratings.size() * sizeof(float));
  std::memcpy(out->offsets, offsets.data(), offsets.size() * sizeof(int64_t));
  std::memcpy(out->users, users.data(), users.size() * sizeof(int64_t));
  return out;
}

void seqrec_free_sequences(SeqData* d) {
  if (!d) return;
  std::free(d->items);
  std::free(d->ratings);
  std::free(d->offsets);
  std::free(d->users);
  std::free(d);
}

struct TripletData {
  int64_t* users;
  int32_t* items;
  float* ratings;
  int64_t n;
};

// Parse a *_set_triplets file (one "u i r" per line).
TripletData* seqrec_load_triplets(const char* path) {
  size_t size = 0;
  char* buf = read_file(path, &size);
  if (!buf) return nullptr;

  std::vector<int64_t> users;
  std::vector<int32_t> items;
  std::vector<float> ratings;
  users.reserve(size / 12);

  const char* p = buf;
  const char* end = buf + size;
  while (p < end) {
    skip_ws(p);
    if (*p == '\n') {
      ++p;
      continue;
    }
    if (p >= end || *p == '\0') break;
    users.push_back(static_cast<int64_t>(parse_number(p)));
    items.push_back(static_cast<int32_t>(parse_number(p)));
    ratings.push_back(static_cast<float>(parse_number(p)));
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }
  std::free(buf);

  TripletData* out = static_cast<TripletData*>(std::malloc(sizeof(TripletData)));
  out->n = static_cast<int64_t>(users.size());
  out->users = static_cast<int64_t*>(std::malloc(users.size() * sizeof(int64_t)));
  out->items = static_cast<int32_t*>(std::malloc(items.size() * sizeof(int32_t)));
  out->ratings = static_cast<float*>(std::malloc(ratings.size() * sizeof(float)));
  std::memcpy(out->users, users.data(), users.size() * sizeof(int64_t));
  std::memcpy(out->items, items.data(), items.size() * sizeof(int32_t));
  std::memcpy(out->ratings, ratings.data(), ratings.size() * sizeof(float));
  return out;
}

void seqrec_free_triplets(TripletData* d) {
  if (!d) return;
  std::free(d->users);
  std::free(d->items);
  std::free(d->ratings);
  std::free(d);
}

}  // extern "C"
