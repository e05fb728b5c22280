// Fast reader for DeepLabCut/Lightning-Pose prediction CSVs.
//
// Layout (reference format, eks/utils.py:188): three header rows
// (scorer / bodyparts / coords) and an index column, then float rows.
// A copy of the JAX package's reader (same code, same parse). pandas'
// generic CSV machinery is slow for large sessions; this parser does one
// read + two passes (count, parse) with no per-cell allocation, and parses
// with correctly rounded from_chars/strtod, so it gives the same float64
// bits as the JAX package's reader.
//
// C ABI (ctypes):
//   dlc_csv_open(path)            -> handle (0 on failure)
//   dlc_csv_rows/cols(handle)     -> data shape (excluding index column)
//   dlc_csv_header(handle, row)   -> '\x1f'-separated header line cells
//   dlc_csv_data(handle)          -> double* row-major (rows x cols)
//   dlc_csv_close(handle)

#include <cstdint>
#include <charconv>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct ParsedCsv {
  std::vector<std::string> headers;  // raw header lines, cells joined by \x1f
  std::vector<double> data;          // row-major, index column dropped
  int64_t rows = 0;
  int64_t cols = 0;
  std::string header_buf;  // returned storage for dlc_csv_header
};

// split a CSV line (no quoted-comma support: DLC headers never contain
// commas inside cells) and join with the unit separator
std::string join_cells(const char* line, size_t len) {
  std::string out;
  out.reserve(len + 8);
  for (size_t i = 0; i < len; ++i) {
    char c = line[i];
    if (c == '\r' || c == '\n') break;
    out.push_back(c == ',' ? '\x1f' : c);
  }
  return out;
}

}  // namespace

extern "C" {

void* dlc_csv_open(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf;
  buf.resize(static_cast<size_t>(size));
  if (size > 0 && std::fread(&buf[0], 1, static_cast<size_t>(size), f) !=
                      static_cast<size_t>(size)) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);

  auto* out = new ParsedCsv();

  const char* p = buf.data();
  const char* end = p + buf.size();

  // three header rows
  for (int h = 0; h < 3 && p < end; ++h) {
    const char* nl = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    size_t len = nl ? static_cast<size_t>(nl - p) : static_cast<size_t>(end - p);
    out->headers.push_back(join_cells(p, len));
    p = nl ? nl + 1 : end;
  }
  if (out->headers.size() != 3) {
    delete out;
    return nullptr;
  }

  // column count from the coords header row
  int64_t total_cols = 1;
  for (char c : out->headers[2])
    if (c == '\x1f') ++total_cols;
  out->cols = total_cols - 1;  // drop the index column
  if (out->cols <= 0) {
    delete out;
    return nullptr;
  }

  // parse data rows
  const char* q = p;
  int64_t rows = 0;
  while (q < end) {
    const char* nl = static_cast<const char*>(
        std::memchr(q, '\n', static_cast<size_t>(end - q)));
    size_t len = nl ? static_cast<size_t>(nl - q) : static_cast<size_t>(end - q);
    if (len > 0 && q[0] != '\r') ++rows;
    q = nl ? nl + 1 : end;
  }
  out->rows = rows;
  out->data.resize(static_cast<size_t>(rows * out->cols));

  double* dst = out->data.data();
  q = p;
  for (int64_t r = 0; r < rows && q < end;) {
    const char* nl = static_cast<const char*>(
        std::memchr(q, '\n', static_cast<size_t>(end - q)));
    const char* line_end = nl ? nl : end;
    if (line_end == q || q[0] == '\r') {
      q = nl ? nl + 1 : end;
      continue;
    }
    // skip the index cell
    const char* cell = static_cast<const char*>(
        std::memchr(q, ',', static_cast<size_t>(line_end - q)));
    if (!cell) {
      delete out;
      return nullptr;
    }
    ++cell;
    for (int64_t c = 0; c < out->cols; ++c) {
      const char* comma = static_cast<const char*>(
          std::memchr(cell, ',', static_cast<size_t>(line_end - cell)));
      const char* cell_end = comma ? comma : line_end;
      // from_chars is correctly rounded like glibc strtod (identical
      // values) at a fraction of the cost; strtod remains the fallback for
      // forms from_chars rejects (leading '+'/whitespace), empty cells and
      // non-numerics become NaN as before
      double v;
      auto res = std::from_chars(cell, cell_end, v);
      if (res.ec != std::errc()) {
        char* next = nullptr;
        v = std::strtod(cell, &next);
        if (next == cell) v = std::strtod("nan", nullptr);
      }
      *dst++ = v;
      if (!comma) break;
      cell = comma + 1;
    }
    ++r;
    q = nl ? nl + 1 : end;
  }
  return out;
}

int64_t dlc_csv_rows(void* h) { return static_cast<ParsedCsv*>(h)->rows; }
int64_t dlc_csv_cols(void* h) { return static_cast<ParsedCsv*>(h)->cols; }

const char* dlc_csv_header(void* h, int row) {
  auto* p = static_cast<ParsedCsv*>(h);
  if (row < 0 || row >= static_cast<int>(p->headers.size())) return "";
  p->header_buf = p->headers[static_cast<size_t>(row)];
  return p->header_buf.c_str();
}

const double* dlc_csv_data(void* h) {
  return static_cast<ParsedCsv*>(h)->data.data();
}

void dlc_csv_close(void* h) { delete static_cast<ParsedCsv*>(h); }

}  // extern "C"
