// Fast DLC-CSV writer: pandas-byte-identical output for float32/float64
// tables with a unit-step integer index.
//
// pandas' to_csv renders each float with NumPy's repr — the SHORTEST digit
// string that round-trips, placed in fixed notation for decimal exponents
// in [-4, 16) and scientific (two-digit, signed exponent) otherwise, with
// ".0" appended to integral fixed-form values and NaN as an empty field.
// std::to_chars(scientific) produces the same shortest digits (both are
// correct shortest-round-trip algorithms, whose output is unique); the
// formatter below re-applies the Python placement rules so the bytes match
// pandas exactly (verified by tests/test_torch_native.py byte-equality
// tests).
//
// Counterpart of fast_csv.cpp (the reader); a copy of the JAX package's
// writer. chip_smoke.py times it against pandas to_csv on the headline
// output table.

#include <charconv>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

namespace {

template <typename T>
size_t format_python_repr(T v, char* out) {
    if (std::isnan(v)) return 0;  // pandas: empty field
    if (std::isinf(v)) {
        const char* s = v < 0 ? "-inf" : "inf";
        size_t n = std::strlen(s);
        std::memcpy(out, s, n);
        return n;
    }
    char buf[48];
    auto res =
        std::to_chars(buf, buf + sizeof(buf), v, std::chars_format::scientific);
    char* p = buf;
    bool neg = false;
    if (*p == '-') {
        neg = true;
        ++p;
    }
    const char* end = res.ptr;  // to_chars output is NOT null-terminated
    char digits[40];
    int nd = 0;
    digits[nd++] = *p++;
    if (*p == '.') {
        ++p;
        while (*p != 'e') digits[nd++] = *p++;
    }
    ++p;  // skip 'e'
    bool exp_neg = (*p == '-');
    if (*p == '+' || *p == '-') ++p;
    int exp10 = 0;
    while (p < end) exp10 = exp10 * 10 + (*p++ - '0');
    if (exp_neg) exp10 = -exp10;

    char* o = out;
    if (neg) *o++ = '-';
    if (exp10 >= -4 && exp10 < 16) {
        if (exp10 >= nd - 1) {
            std::memcpy(o, digits, nd);
            o += nd;
            for (int i = 0; i < exp10 - (nd - 1); ++i) *o++ = '0';
            *o++ = '.';
            *o++ = '0';
        } else if (exp10 >= 0) {
            std::memcpy(o, digits, exp10 + 1);
            o += exp10 + 1;
            *o++ = '.';
            std::memcpy(o, digits + exp10 + 1, nd - exp10 - 1);
            o += nd - exp10 - 1;
        } else {
            *o++ = '0';
            *o++ = '.';
            for (int i = 0; i < -exp10 - 1; ++i) *o++ = '0';
            std::memcpy(o, digits, nd);
            o += nd;
        }
    } else {
        *o++ = digits[0];
        if (nd > 1) {
            *o++ = '.';
            std::memcpy(o, digits + 1, nd - 1);
            o += nd - 1;
        }
        *o++ = 'e';
        int e = exp10;
        *o++ = e < 0 ? '-' : '+';
        if (e < 0) e = -e;
        char eb[8];
        int en = 0;
        do {
            eb[en++] = static_cast<char>('0' + e % 10);
            e /= 10;
        } while (e);
        while (en < 2) eb[en++] = '0';  // Python: at least two exponent digits
        for (int i = en - 1; i >= 0; --i) *o++ = eb[i];
    }
    return static_cast<size_t>(o - out);
}

template <typename T>
long write_impl(const char* path, const char* header, long long header_len,
                const T* data, long long rows, long long cols,
                long long index_start) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    std::string buf;
    const size_t flush_at = (1u << 20);
    buf.reserve(flush_at + 8192);
    if (header_len > 0) buf.append(header, static_cast<size_t>(header_len));
    char tmp[64];
    for (long long r = 0; r < rows; ++r) {
        auto ir = std::to_chars(tmp, tmp + sizeof(tmp), index_start + r);
        buf.append(tmp, static_cast<size_t>(ir.ptr - tmp));
        const T* row = data + r * cols;
        for (long long c = 0; c < cols; ++c) {
            buf.push_back(',');
            size_t n = format_python_repr<T>(row[c], tmp);
            buf.append(tmp, n);
        }
        buf.push_back('\n');
        if (buf.size() >= flush_at) {
            if (std::fwrite(buf.data(), 1, buf.size(), f) != buf.size()) {
                std::fclose(f);
                return -2;
            }
            buf.clear();
        }
    }
    if (!buf.empty() &&
        std::fwrite(buf.data(), 1, buf.size(), f) != buf.size()) {
        std::fclose(f);
        return -2;
    }
    long rc = std::ferror(f) ? -2 : 0;
    if (std::fclose(f) != 0) rc = -2;  // the final flush can fail (ENOSPC)
    return rc;
}

}  // namespace

extern "C" {

long dlc_csv_write_f32(const char* path, const char* header,
                       long long header_len, const float* data, long long rows,
                       long long cols, long long index_start) {
    return write_impl<float>(path, header, header_len, data, rows, cols,
                             index_start);
}

long dlc_csv_write_f64(const char* path, const char* header,
                       long long header_len, const double* data,
                       long long rows, long long cols, long long index_start) {
    return write_impl<double>(path, header, header_len, data, rows, cols,
                              index_start);
}

}  // extern "C"
