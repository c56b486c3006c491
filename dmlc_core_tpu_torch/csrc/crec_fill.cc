// .crec host batches read in place from a read-only mapping of the file.
//
// The port's own copy of the fill of cpp/src/csr_rec.cc (CsrRecBatcher::
// FillPacked), which is shared with the JAX package's native library and
// is not edited. That fill reads the file through a threaded InputSplit:
// chunks are copied from the file into a buffer, records are framed there,
// and their planes are copied again into the batch. Every fill also
// rewrites the whole padding tail of every shard's nonzero planes.
//
// This one maps the file once (PROT_READ, MAP_PRIVATE), read in sequence:
// the kernel is told so (MADV_SEQUENTIAL) and asked to read a window of
// kAheadBytes ahead of the fill (MADV_WILLNEED), so opening reads nothing
// and a file larger than memory streams through the page cache. It frames
// the RecordIO records in the mapping and copies each record's
// col/val/field and row-wise planes straight from there into the packed
// batch (big [D, kb, bucket], aux [D, ka, R], int32 words). Only a record
// split around an embedded magic word (RecordIO's escape) is assembled in a
// buffer first, as the shared reader assembles it.
//
// What a buffer already holds. The caller keeps, for each pooled buffer and
// each shard d, the index clean[d] from which the shard's nonzero planes are
// known to hold padding (row R, col 0, val 0, field 0): the bucket for a
// fresh buffer, and after a fill the number of useful entries that fill
// wrote. A fill writes padding only over [useful, clean[d]), where the
// buffer's previous fill left useful entries, and reports how many entries
// it padded. The caller also keeps the row lengths of the buffer's last fill
// (kNoRow for a row it did not hold): while a shard's rows repeat them from
// the shard's first row on, their row ids are already in place and are not
// written again. The planes come out bit for bit as FillPacked writes them.
//
// The record layout, the static per-shard bucket (from the first record's
// window table) and every check are FillPacked's (cpp/src/csr_rec.h).
// This path reads one local file, whole or as part `part` of `npart`
// byte ranges, in order (no shuffle, as the shared .crec split does not
// shuffle). A part holds the records whose frame head lies in its range,
// the range's ends moved forward to the next frame head as the shared
// RecordIO split moves them (cpp/src/input_split.cc, ByteSplit::
// ResetPartition and RecordIOSplit::SeekRecordHead), so the parts are the
// shared split's, record for record.

#include <fcntl.h>
#if defined(__SSE2__)
#include <emmintrin.h>
#endif
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <sstream>
#include <stdexcept>
#include <string>

namespace {

constexpr uint32_t kRecordMagic = 0xced7230a;  // RecordIO frame magic
constexpr uint32_t kCrecMagic = 0x44524331;    // 'DRC1' payload magic
constexpr uint32_t kNoRow = 0xffffffffu;       // a row the buffer lacks
constexpr size_t kAheadBytes = size_t(64) << 20;  // read ahead of the fill

thread_local std::string last_error;

struct Failure : std::runtime_error {
  using std::runtime_error::runtime_error;
};

#define CREC_CHECK(cond, msg)         \
  do {                                \
    if (!(cond)) {                    \
      std::ostringstream os_;         \
      os_ << msg;                     \
      throw Failure(os_.str());       \
    }                                 \
  } while (0)

// the file is little-endian, as is every host the port runs on
inline uint32_t Word(const char* p) {
  uint32_t w;
  std::memcpy(&w, p, 4);
  return w;
}

inline uint64_t Word64(const char* p) {
  uint64_t w;
  std::memcpy(&w, p, 8);
  return w;
}

// The batch's planes are written once and next read by the card's copy,
// not by this core: streaming (non-temporal) stores write them without
// first reading each line into the cache. Fill() fences them before it
// returns.
inline void StreamWords(int32_t* dst, const char* src, uint64_t n) {
  uint64_t i = 0;
#if defined(__SSE2__)
  for (; i < n && (reinterpret_cast<uintptr_t>(dst + i) & 15); ++i)
    std::memcpy(dst + i, src + 4 * i, 4);
  for (; i + 4 <= n; i += 4) {
    _mm_stream_si128(
        reinterpret_cast<__m128i*>(dst + i),
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + 4 * i)));
  }
#endif
  std::memcpy(dst + i, src + 4 * i, (n - i) * 4);
}

inline void StreamFill(int32_t* dst, int32_t value, uint64_t n) {
  uint64_t i = 0;
#if defined(__SSE2__)
  for (; i < n && (reinterpret_cast<uintptr_t>(dst + i) & 15); ++i)
    dst[i] = value;
  const __m128i v = _mm_set1_epi32(value);
  for (; i + 4 <= n; i += 4)
    _mm_stream_si128(reinterpret_cast<__m128i*>(dst + i), v);
#endif
  for (; i < n; ++i) dst[i] = value;
}

inline void StreamFence() {
#if defined(__SSE2__)
  _mm_sfence();
#endif
}

// Row ids written run by run through a small buffer in the cache, then
// streamed to the plane.
class RowIdWriter {
 public:
  explicit RowIdWriter(int32_t* dst) : dst_(dst) {}
  void Run(int32_t id, uint64_t n) {
    while (n > 0) {
      const uint64_t take = std::min<uint64_t>(n, kSize - used_);
      std::fill(buf_ + used_, buf_ + used_ + take, id);
      used_ += take;
      n -= take;
      if (used_ == kSize) Flush();
    }
  }
  void Flush() {
    StreamWords(dst_, reinterpret_cast<const char*>(buf_), used_);
    dst_ += used_;
    used_ = 0;
  }

 private:
  static constexpr uint64_t kSize = 2048;
  int32_t buf_[kSize];
  int32_t* dst_;
  uint64_t used_ = 0;
};

class MappedCrec {
 public:
  MappedCrec(const char* path, uint64_t batch_rows, uint32_t num_shards,
             uint64_t min_bucket, uint32_t part, uint32_t npart)
      : batch_rows_(batch_rows),
        num_shards_(num_shards),
        min_bucket_(std::max<uint64_t>(min_bucket, 1)) {
    CREC_CHECK(num_shards_ > 0, "num_shards must be positive");
    CREC_CHECK(batch_rows_ > 0 && batch_rows_ % num_shards_ == 0,
               "batch_rows=" << batch_rows_ << " must divide by shards="
                             << num_shards_);
    CREC_CHECK(part < npart, "part index out of range");
    const int fd = ::open(path, O_RDONLY | O_CLOEXEC);
    CREC_CHECK(fd >= 0, "cannot open " << path << ": "
                                       << std::strerror(errno));
    struct stat st;
    if (::fstat(fd, &st) != 0) {
      const int e = errno;
      ::close(fd);
      CREC_CHECK(false, "cannot stat " << path << ": " << std::strerror(e));
    }
    size_ = static_cast<size_t>(st.st_size);
    if (size_ > 0) {
      void* p = ::mmap(nullptr, size_, PROT_READ, MAP_PRIVATE, fd, 0);
      const int e = errno;
      ::close(fd);
      CREC_CHECK(p != MAP_FAILED,
                 "cannot map " << path << ": " << std::strerror(e));
      base_ = static_cast<const char*>(p);
      ::madvise(p, size_, MADV_SEQUENTIAL);  // a hint: its failure is fine
    } else {
      ::close(fd);
    }
    // the part's byte range, as ByteSplit::ResetPartition cuts it (4-byte
    // aligned steps, each end moved to the next frame head)
    size_t step = (size_ + npart - 1) / npart;
    step = (step + 3) / 4 * 4;
    begin_ = HeadAtOrAfter(std::min(size_, step * part));
    end_ = HeadAtOrAfter(std::min(size_, step * (part + 1)));
    BeforeFirst();
  }

  ~MappedCrec() {
    if (base_ != nullptr) ::munmap(const_cast<char*>(base_), size_);
  }

  void Meta(uint64_t* bucket, int32_t* hw, int32_t* hq, int32_t* hf) {
    Peek();
    CREC_CHECK(has_weight_ >= 0,
               "csr rec source is empty; cannot determine the batch shape");
    *bucket = bucket_;
    *hw = has_weight_;
    *hq = has_qid_;
    *hf = has_field_;
  }

  void BeforeFirst() {
    pos_ = begin_;
    ahead_ = begin_;
    eof_ = false;
    have_record_ = false;
    row_in_rec_ = 0;
    nnz_in_rec_ = 0;
    rec_rows_ = 0;
    rec_nnz_ = 0;
  }

  uint64_t bytes_read() const { return bytes_read_; }

  uint64_t Fill(int32_t* big, int32_t kb, int32_t* aux, int32_t ka,
                int32_t* nrows, uint64_t* clean, uint32_t* lens_prev,
                uint64_t* pad_written);

 private:
  bool NextFrame(const char** data, uint64_t* size);
  bool AdvanceRecord();
  size_t HeadAtOrAfter(size_t ofs) const;
  void ReadAhead();
  void Peek() {
    if (has_weight_ < 0 && !eof_) AdvanceRecord();
  }

  const uint64_t batch_rows_;
  const uint32_t num_shards_;
  const uint64_t min_bucket_;
  const char* base_ = nullptr;
  size_t size_ = 0;
  size_t begin_ = 0;        // the part's first frame head
  size_t end_ = 0;          // the next part's first frame head, or size_
  size_t pos_ = 0;          // offset of the next RecordIO frame
  size_t ahead_ = 0;        // read-ahead asked for up to here
  std::string assembled_;   // a record split around an embedded magic

  // the current record's planes (in the mapping, or in assembled_)
  const char* row_len_ = nullptr;
  const char* labels_ = nullptr;
  const char* weights_ = nullptr;
  const char* qids_ = nullptr;
  const char* cols_ = nullptr;
  const char* vals_ = nullptr;
  const char* fields_ = nullptr;
  uint64_t rec_rows_ = 0;
  uint64_t rec_nnz_ = 0;
  uint64_t row_in_rec_ = 0;
  uint64_t nnz_in_rec_ = 0;

  // the static shape, pinned by the first record
  int32_t has_weight_ = -1;
  int32_t has_qid_ = -1;
  int32_t has_field_ = -1;
  uint64_t bucket_ = 0;

  bool have_record_ = false;
  bool eof_ = false;
  uint64_t bytes_read_ = 0;
};

// The first frame head (RecordIO magic, cflag 0 or 1) at a 4-aligned
// offset at or after ofs, or size_ (RecordIOSplit::SeekRecordHead); 0 and
// size_ stay as they are.
size_t MappedCrec::HeadAtOrAfter(size_t ofs) const {
  if (ofs == 0 || ofs >= size_) return std::min(ofs, size_);
  for (size_t p = (ofs + 3) & ~size_t(3); p + 8 <= size_; p += 4) {
    if (Word(base_ + p) == kRecordMagic &&
        ((Word(base_ + p + 4) >> 29) & 7u) <= 1)
      return p;
  }
  return size_;
}

// Ask for the pages of the next kAheadBytes of the part once the fill is
// within half of that of the last window's end.
void MappedCrec::ReadAhead() {
  if (ahead_ >= end_ || (ahead_ > pos_ && ahead_ - pos_ > kAheadBytes / 2))
    return;
  const size_t page = static_cast<size_t>(::sysconf(_SC_PAGESIZE));
  const size_t from = std::max(ahead_, pos_) & ~(page - 1);
  ahead_ = std::min(end_, std::max(ahead_, pos_) + kAheadBytes);
  ::madvise(const_cast<char*>(base_) + from, ahead_ - from, MADV_WILLNEED);
}

// The next record's payload: in place for a whole frame, reassembled for a
// frame split around embedded magic words (cflag 1, 2..., 3).
bool MappedCrec::NextFrame(const char** data, uint64_t* size) {
  bool multipart = false;
  ReadAhead();
  while (true) {
    if (pos_ + 8 > end_) {
      CREC_CHECK(!multipart, "truncated recordio chunk");
      pos_ = end_;
      return false;
    }
    const char* head = base_ + pos_;
    CREC_CHECK(Word(head) == kRecordMagic, "bad recordio magic in chunk");
    const uint32_t lrec = Word(head + 4);
    const uint32_t cflag = (lrec >> 29) & 7u;
    const uint64_t len = lrec & ((1u << 29) - 1);
    const size_t next = pos_ + 8 + ((len + 3) & ~uint64_t(3));
    CREC_CHECK(next <= end_, "recordio record overruns chunk");
    pos_ = next;
    if (cflag == 0) {
      CREC_CHECK(!multipart, "unexpected cflag=0 inside multi-part record");
      *data = head + 8;
      *size = len;
      return true;
    }
    if (cflag == 1) {
      CREC_CHECK(!multipart, "unexpected cflag=1 inside multi-part record");
      multipart = true;
      assembled_.assign(head + 8, len);
      continue;
    }
    CREC_CHECK(multipart, "continuation part without a head");
    const uint32_t m = kRecordMagic;
    assembled_.append(reinterpret_cast<const char*>(&m), 4);
    assembled_.append(head + 8, len);
    if (cflag == 3) {
      *data = assembled_.data();
      *size = assembled_.size();
      return true;
    }
    CREC_CHECK(cflag == 2, "invalid recordio cflag");
  }
}

bool MappedCrec::AdvanceRecord() {
  const char* p = nullptr;
  uint64_t size = 0;
  if (!NextFrame(&p, &size)) {
    eof_ = true;
    have_record_ = false;
    return false;
  }
  bytes_read_ += size;
  CREC_CHECK(size >= 32, "csr rec record too short for its header");
  CREC_CHECK(Word(p) == kCrecMagic,
             "not a csr-plane record (bad payload magic); .crec files are "
             "written by rows_to_csr_recordio (dmlc_core_tpu/io/convert.py)");
  const uint32_t flags = Word(p + 4);
  const uint64_t rows = Word(p + 8);
  const uint32_t nwin = Word(p + 12);
  const uint64_t nnz = Word64(p + 16);
  const uint32_t max_col = Word(p + 24);
  CREC_CHECK(rows <= (1u << 30) && nnz <= (1ull << 34) && nwin <= 64,
             "corrupt csr rec header: rows=" << rows << " nnz=" << nnz
                                             << " nwin=" << nwin);
  CREC_CHECK(max_col <= 0x7fffffffu,
             "csr rec feature index " << max_col
                                      << " exceeds the int32 device layout");
  const int32_t hw = static_cast<int32_t>(flags & 1u);
  const int32_t hq = static_cast<int32_t>((flags >> 1) & 1u);
  const int32_t hf = static_cast<int32_t>((flags >> 2) & 1u);
  CREC_CHECK(nwin >= 1 && size >= 32 + 8ull * nwin,
             "csr rec record truncated inside its window table");
  if (has_weight_ < 0) {
    has_weight_ = hw;
    has_qid_ = hq;
    has_field_ = hf;
    const uint64_t R = batch_rows_ / num_shards_;
    uint32_t wi = 0;
    while ((1ull << wi) < R && wi + 1 < nwin) ++wi;
    const uint64_t bound = Word64(p + 32 + 8 * wi);
    CREC_CHECK(bound <= (1ull << 34),
               "corrupt csr rec window table: bound " << bound);
    uint64_t bkt = min_bucket_;
    while (bkt < bound) bkt <<= 1;
    bucket_ = bkt;
  } else {
    CREC_CHECK(hw == has_weight_ && hq == has_qid_ && hf == has_field_,
               "csr rec record flag drift: got w/q/f="
                   << hw << hq << hf << ", pinned " << has_weight_
                   << has_qid_ << has_field_);
  }
  const uint64_t need = 32 + 8ull * nwin + rows * 4 + rows * 4 +
                        (hw ? rows * 4 : 0) + (hq ? rows * 4 : 0) + nnz * 4 +
                        nnz * 4 + (hf ? nnz * 4 : 0);
  CREC_CHECK(size >= need, "truncated csr rec record: " << size
                                                        << " bytes, need "
                                                        << need);
  row_len_ = p + 32 + 8 * static_cast<uint64_t>(nwin);
  labels_ = row_len_ + rows * 4;
  weights_ = hw ? labels_ + rows * 4 : nullptr;
  qids_ = hq ? (hw ? weights_ : labels_) + rows * 4 : nullptr;
  cols_ = (hq ? qids_ : (hw ? weights_ : labels_)) + rows * 4;
  vals_ = cols_ + nnz * 4;
  fields_ = hf ? vals_ + nnz * 4 : nullptr;
  rec_rows_ = rows;
  rec_nnz_ = nnz;
  row_in_rec_ = 0;
  nnz_in_rec_ = 0;
  have_record_ = true;
  return true;
}

uint64_t MappedCrec::Fill(int32_t* big, int32_t kb, int32_t* aux,
                          int32_t ka, int32_t* nrows, uint64_t* clean,
                          uint32_t* lens_prev, uint64_t* pad_written) {
  Peek();
  CREC_CHECK(has_weight_ >= 0,
             "csr rec source is empty; cannot determine the batch shape");
  CREC_CHECK(kb == 3 + has_field_, "packed big has "
                                       << kb << " planes but the file needs "
                                       << 3 + has_field_);
  CREC_CHECK(ka == 3 + has_qid_, "packed aux has "
                                     << ka << " planes but the file needs "
                                     << 3 + has_qid_);
  const uint64_t R = batch_rows_ / num_shards_;
  const uint64_t B = bucket_;
  const uint64_t nnz_stride = static_cast<uint64_t>(kb) * B;
  const uint64_t row_stride = static_cast<uint64_t>(ka) * R;
  uint64_t filled = 0;
  uint64_t shard_written = 0;
  bool same = true;  // the shard's rows so far are its previous fill's
  *pad_written = 0;
  // pad shard d's nonzero planes over [useful, clean[d]): what the
  // buffer's previous fill left there
  auto pad_shard = [&](uint32_t d, uint64_t useful) {
    int32_t* planes = big + d * nnz_stride;
    const uint64_t stale = std::min(clean[d], B);
    if (useful < stale) {
      StreamFill(planes + useful, static_cast<int32_t>(R), stale - useful);
      for (int32_t p = 1; p < kb; ++p) {
        StreamFill(planes + p * B + useful, 0, stale - useful);
      }
      *pad_written += stale - useful;
    }
    clean[d] = useful;
  };
  while (filled < batch_rows_) {
    if (!have_record_ || row_in_rec_ >= rec_rows_) {
      if (eof_ || !AdvanceRecord()) break;
      if (rec_rows_ == 0) continue;
    }
    const uint32_t d = static_cast<uint32_t>(filled / R);
    if (filled % R == 0) {
      shard_written = 0;
      same = true;
    }
    const uint64_t n = std::min({R * (d + 1) - filled, batch_rows_ - filled,
                                 rec_rows_ - row_in_rec_});
    int32_t* planes = big + d * nnz_stride;
    const uint64_t local0 = filled - static_cast<uint64_t>(d) * R;
    uint64_t span_nnz = 0;
    uint64_t kept_rows = 0, kept_nnz = 0;  // leading rows whose ids stay
    const char* lens = row_len_ + row_in_rec_ * 4;
    uint32_t* prev = lens_prev + d * R + local0;
    for (uint64_t i = 0; i < n; ++i) {
      const uint32_t l = Word(lens + i * 4);
      span_nnz += l;
      CREC_CHECK(shard_written + span_nnz <= B,
                 "csr rec shard nnz exceeds the file's window bound "
                 "(corrupt row_len or window table)");
      same = same && prev[i] == l;
      if (same) {
        kept_rows = i + 1;
        kept_nnz = span_nnz;
      }
      prev[i] = l;
    }
    CREC_CHECK(nnz_in_rec_ + span_nnz <= rec_nnz_,
               "csr rec row lengths overrun the record's nnz");
    RowIdWriter ids(planes + shard_written + kept_nnz);
    for (uint64_t i = kept_rows; i < n; ++i) {
      ids.Run(static_cast<int32_t>(local0 + i), Word(lens + i * 4));
    }
    ids.Flush();
    const uint64_t at = shard_written;
    StreamWords(planes + B + at, cols_ + nnz_in_rec_ * 4, span_nnz);
    StreamWords(planes + 2 * B + at, vals_ + nnz_in_rec_ * 4, span_nnz);
    if (has_field_ == 1) {
      StreamWords(planes + 3 * B + at, fields_ + nnz_in_rec_ * 4, span_nnz);
    }
    int32_t* rows_d = aux + d * row_stride + local0;
    std::memcpy(rows_d, labels_ + row_in_rec_ * 4, n * 4);
    if (weights_ != nullptr) {
      std::memcpy(rows_d + R, weights_ + row_in_rec_ * 4, n * 4);
    } else {
      const float one = 1.0f;
      int32_t bits;
      std::memcpy(&bits, &one, 4);
      std::fill(rows_d + R, rows_d + R + n, bits);
    }
    if (has_qid_ == 1) {
      std::memcpy(rows_d + 2 * R, qids_ + row_in_rec_ * 4, n * 4);
    }
    shard_written += span_nnz;
    nnz_in_rec_ += span_nnz;
    row_in_rec_ += n;
    filled += n;
    if (filled % R == 0 || filled == batch_rows_) pad_shard(d, shard_written);
  }
  if (filled == 0) return 0;
  if (filled % R != 0) {  // data ended mid-shard
    pad_shard(static_cast<uint32_t>(filled / R), shard_written);
  }
  for (uint32_t d = static_cast<uint32_t>((filled + R - 1) / R);
       d < num_shards_; ++d) {
    pad_shard(d, 0);
  }
  for (uint32_t d = 0; d < num_shards_; ++d) {
    const int64_t left = static_cast<int64_t>(filled) - d * R;
    const uint64_t count = static_cast<uint64_t>(
        std::max<int64_t>(0, std::min<int64_t>(left, R)));
    int32_t* rows_d = aux + d * row_stride;
    if (count < R) {  // padding rows: weight 0 drops them from the loss
      std::fill(lens_prev + d * R + count, lens_prev + (d + 1) * R, kNoRow);
      std::memset(rows_d + count, 0, (R - count) * 4);
      std::memset(rows_d + R + count, 0, (R - count) * 4);
      if (has_qid_ == 1) std::fill(rows_d + 2 * R + count, rows_d + 3 * R, -1);
    }
    int32_t* nplane = rows_d + static_cast<uint64_t>(ka - 1) * R;
    std::memset(nplane, 0, R * 4);
    nplane[0] = static_cast<int32_t>(count);
    nrows[d] = static_cast<int32_t>(count);
  }
  StreamFence();
  return filled;
}

template <typename Fn>
int Guarded(Fn fn) {
  try {
    fn();
    return 0;
  } catch (const std::exception& e) {
    last_error = e.what();
  } catch (...) {
    last_error = "unknown C++ exception";
  }
  return -1;
}

}  // namespace

// The message of the calling thread's last failed call.
extern "C" const char* dct_crec_map_last_error() {
  return last_error.c_str();
}

// Maps the .crec file at `path` for batches of batch_rows rows over
// num_shards shards, reading part `part` of `npart`; *out is the handle.
// Returns 0, or -1 (see dct_crec_map_last_error).
extern "C" int dct_crec_map_open(const char* path, uint64_t batch_rows,
                                 uint32_t num_shards,
                                 uint64_t min_nnz_bucket, uint32_t part,
                                 uint32_t npart, void** out) {
  return Guarded([&] {
    *out = new MappedCrec(path, batch_rows, num_shards, min_nnz_bucket, part,
                          npart);
  });
}

// The static batch shape: the per-shard nnz bucket and the optional planes.
extern "C" int dct_crec_map_meta(void* h, uint64_t* bucket,
                                 int32_t* has_weight, int32_t* has_qid,
                                 int32_t* has_field) {
  return Guarded([&] {
    static_cast<MappedCrec*>(h)->Meta(bucket, has_weight, has_qid,
                                      has_field);
  });
}

// One batch into big [D, kb, bucket] and aux [D, ka, R] (FillPacked's
// layout) and nrows [D]; clean [D] (the buffer's padded extent) and
// lens_prev [D, R] (its rows' lengths) describe the buffer and are updated;
// *pad_written the padding entries written, *take the true row count (0
// at the end).
extern "C" int dct_crec_map_fill(void* h, int32_t* big, int32_t kb,
                                 int32_t* aux, int32_t ka, int32_t* nrows,
                                 uint64_t* clean, uint32_t* lens_prev,
                                 uint64_t* pad_written, uint64_t* take) {
  return Guarded([&] {
    *take = static_cast<MappedCrec*>(h)->Fill(big, kb, aux, ka, nrows, clean,
                                              lens_prev, pad_written);
  });
}

// Restart from the first record.
extern "C" int dct_crec_map_before_first(void* h) {
  return Guarded([&] { static_cast<MappedCrec*>(h)->BeforeFirst(); });
}

// Record payload bytes consumed so far.
extern "C" int dct_crec_map_bytes_read(void* h, uint64_t* out) {
  return Guarded([&] { *out = static_cast<MappedCrec*>(h)->bytes_read(); });
}

// Unmaps the file and frees the handle.
extern "C" int dct_crec_map_free(void* h) {
  return Guarded([&] { delete static_cast<MappedCrec*>(h); });
}
