// femto_io: native corpus preparation for femto_tpu.
//
// The reference feeds its indexer through C input plugins implementing a
// two-pass document reader ABI (its_use_arguments/get_doc_info/
// switch_passes/get_doc, /root/reference/src/dcx_cc/index_tool_support.h:
// 20-120) with multithreaded staging.  This library is femto_tpu's
// equivalent: it walks files, reads them with a thread pool, and writes the
// prepared uint16 alphabet stream (byte+CHARACTER_OFFSET, SEOF terminator
// per document) plus the int64 doc-start prefix array directly into
// caller-provided buffers — zero-copy into numpy via ctypes.
//
// Exposed C ABI (see femto_tpu/io/native.py):
//   ft_corpus_sizes(paths, n_paths, &total_alpha, &n_docs)
//   ft_corpus_fill(paths, n_paths, text_out, starts_out, n_threads)
//   ft_fasta_sizes / ft_fasta_fill: one doc per FASTA record
//   ft_version()

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <sys/stat.h>
#include <thread>
#include <vector>

namespace {

constexpr uint16_t kCharacterOffset = 5;  // matches femto_tpu.alphabet
constexpr uint16_t kSeof = 2;

int64_t file_size(const char* path) {
  struct stat st;
  if (stat(path, &st) != 0) return -1;
  return static_cast<int64_t>(st.st_size);
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  int64_t sz = file_size(path);
  if (sz < 0) {
    fclose(f);
    return false;
  }
  out->resize(static_cast<size_t>(sz));
  size_t got = sz ? fread(out->data(), 1, static_cast<size_t>(sz), f) : 0;
  fclose(f);
  out->resize(got);
  return true;
}

void translate(const uint8_t* src, int64_t len, uint16_t* dst) {
  for (int64_t i = 0; i < len; ++i) {
    dst[i] = static_cast<uint16_t>(src[i]) + kCharacterOffset;
  }
}

struct FastaRecord {
  int64_t seq_len;  // sequence bytes after header stripping
};

// Parse FASTA content: sequence lines concatenated per '>' record,
// uppercased.  Returns per-record lengths; text written if dst != nullptr
// (sequence bytes translated by caller convention: already alpha-coded).
void parse_fasta(const std::vector<uint8_t>& data,
                 std::vector<std::string>* seqs) {
  std::string cur;
  bool have_record = false;
  size_t i = 0;
  const size_t n = data.size();
  while (i < n) {
    size_t j = i;
    while (j < n && data[j] != '\n') ++j;
    size_t end = j;
    if (end > i && data[end - 1] == '\r') --end;
    if (i < n && data[i] == '>') {
      if (have_record) {
        seqs->push_back(std::move(cur));
        cur.clear();
      }
      have_record = true;
    } else if (end > i) {
      if (!have_record) have_record = true;
      for (size_t k = i; k < end; ++k) {
        uint8_t c = data[k];
        if (c >= 'a' && c <= 'z') c -= 32;
        cur.push_back(static_cast<char>(c));
      }
    }
    i = j + 1;
  }
  if (have_record) seqs->push_back(std::move(cur));
}

}  // namespace

extern "C" {

int ft_version() { return 1; }

// Pass 1: compute total prepared length (bytes + 1 SEOF per doc, plus
// SOH+path+EOH when with_path_headers != 0) and doc count.
// Returns 0 on success, -1 if any file is unreadable.
int ft_corpus_sizes(const char** paths, int64_t n_paths,
                    int64_t* total_alpha, int64_t* n_docs) {
  int64_t total = 0;
  for (int64_t i = 0; i < n_paths; ++i) {
    int64_t sz = file_size(paths[i]);
    if (sz < 0) return -1;
    total += sz + 1;  // SEOF terminator
  }
  *total_alpha = total;
  *n_docs = n_paths;
  return 0;
}

int ft_corpus_sizes_hdr(const char** paths, int64_t n_paths,
                        int64_t* total_alpha, int64_t* n_docs) {
  int64_t total = 0;
  for (int64_t i = 0; i < n_paths; ++i) {
    int64_t sz = file_size(paths[i]);
    if (sz < 0) return -1;
    total += sz + 1 + static_cast<int64_t>(strlen(paths[i])) + 2;
  }
  *total_alpha = total;
  *n_docs = n_paths;
  return 0;
}

namespace {
constexpr uint16_t kSoh = 3;
constexpr uint16_t kEoh = 4;

// Shared fill: header_lens == nullptr -> plain layout (content + SEOF);
// otherwise SOH+path+EOH+content+SEOF with per-doc header region lengths.
int corpus_fill_impl(const char** paths, int64_t n_paths, uint16_t* text,
                     int64_t* starts, int64_t* header_lens, int n_threads) {
  starts[0] = 0;
  for (int64_t i = 0; i < n_paths; ++i) {
    int64_t sz = file_size(paths[i]);
    if (sz < 0) return -1;
    int64_t hdr = header_lens
                      ? static_cast<int64_t>(strlen(paths[i])) + 2
                      : 0;
    if (header_lens) header_lens[i] = hdr;
    starts[i + 1] = starts[i] + hdr + sz + 1;
  }
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> next(0);
  std::atomic<int> failed(0);
  auto worker = [&]() {
    std::vector<uint8_t> buf;
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n_paths) return;
      if (!read_file(paths[i], &buf)) {
        failed.store(1);
        return;
      }
      uint16_t* dst = text + starts[i];
      int64_t hdr = header_lens ? header_lens[i] : 0;
      if (hdr) {
        dst[0] = kSoh;
        translate(reinterpret_cast<const uint8_t*>(paths[i]), hdr - 2,
                  dst + 1);
        dst[hdr - 1] = kEoh;
      }
      int64_t want = starts[i + 1] - starts[i] - hdr - 1;
      int64_t len = static_cast<int64_t>(buf.size());
      if (len > want) len = want;  // file changed size: clamp
      translate(buf.data(), len, dst + hdr);
      for (int64_t k = len; k < want; ++k) dst[hdr + k] = kCharacterOffset;
      dst[hdr + want] = kSeof;
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failed.load() ? -1 : 0;
}
}  // namespace

// Pass 2: fill text (uint16[total_alpha]) and starts (int64[n_docs+1]).
// Reads and translates files with a thread pool.
int ft_corpus_fill(const char** paths, int64_t n_paths, uint16_t* text,
                   int64_t* starts, int n_threads) {
  return corpus_fill_impl(paths, n_paths, text, starts, nullptr, n_threads);
}

// Variant storing each file's path as a searchable SOH/EOH header section.
int ft_corpus_fill_hdr(const char** paths, int64_t n_paths, uint16_t* text,
                       int64_t* starts, int64_t* header_lens,
                       int n_threads) {
  return corpus_fill_impl(paths, n_paths, text, starts, header_lens,
                          n_threads);
}

// FASTA: pass 1 computes record count + total length (records across all
// files).  rc != 0 appends the reverse complement to every record.
int ft_fasta_sizes(const char** paths, int64_t n_paths, int rc,
                   int64_t* total_alpha, int64_t* n_docs) {
  int64_t total = 0, docs = 0;
  std::vector<uint8_t> buf;
  std::vector<std::string> seqs;
  for (int64_t i = 0; i < n_paths; ++i) {
    if (!read_file(paths[i], &buf)) return -1;
    seqs.clear();
    parse_fasta(buf, &seqs);
    for (auto& s : seqs) {
      int64_t len = static_cast<int64_t>(s.size()) * (rc ? 2 : 1);
      total += len + 1;
      docs += 1;
    }
  }
  *total_alpha = total;
  *n_docs = docs;
  return 0;
}

int ft_fasta_fill(const char** paths, int64_t n_paths, int rc,
                  uint16_t* text, int64_t* starts) {
  auto comp = [](char c) -> char {
    switch (c) {
      case 'A': return 'T';
      case 'C': return 'G';
      case 'G': return 'C';
      case 'T': return 'A';
      default: return c;  // non-ACGT bytes pass through (python parity)
    }
  };
  std::vector<uint8_t> buf;
  std::vector<std::string> seqs;
  int64_t doc = 0;
  int64_t off = 0;
  starts[0] = 0;
  for (int64_t i = 0; i < n_paths; ++i) {
    if (!read_file(paths[i], &buf)) return -1;
    seqs.clear();
    parse_fasta(buf, &seqs);
    for (auto& s : seqs) {
      for (char c : s) {
        text[off++] = static_cast<uint16_t>(static_cast<uint8_t>(c)) +
                      kCharacterOffset;
      }
      if (rc) {
        for (auto it = s.rbegin(); it != s.rend(); ++it) {
          text[off++] =
              static_cast<uint16_t>(static_cast<uint8_t>(comp(*it))) +
              kCharacterOffset;
        }
      }
      text[off++] = kSeof;
      starts[++doc] = off;
    }
  }
  return 0;
}

// Kasai's linear-time LCP construction: lcp[r] = longest common prefix of
// the suffixes at SA rows r-1 and r (lcp[0] = 0).  The Chapel reference
// computes PLCP on CPU locales (SuffixSortImpl.chpl:3130+); this is the
// single-host native path consumed by femto_tpu.lcp.
int ft_kasai(const uint16_t* text, const int32_t* sa, int64_t n,
             int32_t* lcp) {
  if (n <= 0) return 0;
  std::vector<int32_t> rank(static_cast<size_t>(n));
  for (int64_t r = 0; r < n; ++r) rank[sa[r]] = static_cast<int32_t>(r);
  int64_t h = 0;
  lcp[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = rank[static_cast<size_t>(i)];
    if (r > 0) {
      int64_t j = sa[r - 1];
      while (i + h < n && j + h < n && text[i + h] == text[j + h]) ++h;
      lcp[r] = static_cast<int32_t>(h);
      if (h > 0) --h;
    } else {
      h = 0;
    }
  }
  return 0;
}

}  // extern "C"
