// Native CSV ingest: the numeric fast path of Table.from_csv.
//
// Parses a delimiter-separated byte buffer of n_cols numeric columns into
// a row-major double matrix. Returns the number of rows parsed, or -1 when
// any cell fails to parse as a double (including empty cells) — the Python
// caller then falls back to the general (string-aware) parser. The
// framework analog of the reference's dataset connectors' deserializers
// (which are JVM; SURVEY.md: our native tier covers what the JVM runtime
// covered there).

#include <cstdlib>
#include <cstring>

extern "C" {

long long csv_parse_numeric(const char* buf, long long len, char delimiter,
                            long long n_cols, double* out,
                            long long max_rows) {
    long long row = 0;
    const char* p = buf;
    const char* end = buf + len;
    while (p < end) {
        // skip blank lines (including a trailing newline at EOF)
        if (*p == '\n' || *p == '\r') {
            ++p;
            continue;
        }
        if (row >= max_rows) return -1;
        for (long long c = 0; c < n_cols; ++c) {
            // a short or whitespace-only row must not let strtod skip
            // across the newline: consume in-cell blanks ourselves, then
            // refuse a cell that starts at the line end
            while (p < end && (*p == ' ' || *p == '\t')) ++p;
            if (p >= end || *p == '\n' || *p == '\r') return -1;
            char* cell_end = nullptr;
            double v = strtod(p, &cell_end);
            if (cell_end == p) return -1;  // not a number
            out[c] = v;
            p = cell_end;
            if (c + 1 < n_cols) {
                if (p >= end || *p != delimiter) return -1;
                ++p;
            }
        }
        // row must terminate at a newline (or EOF); tolerate \r\n
        if (p < end && *p == '\r') ++p;
        if (p < end) {
            if (*p != '\n') return -1;  // extra cells / garbage
            ++p;
        }
        ++row;
        out += n_cols;
    }
    return row;
}

}  // extern "C"
