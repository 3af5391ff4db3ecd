"""Text / bag-of-words ops.

The port of ``flink_ml_tpu/models/feature/text.py`` (ref: flink-ml-lib
feature/{tokenizer,regextokenizer,ngram,stopwordsremover,hashingtf,
countvectorizer,idf,featurehasher}/).

String data runs on the host: token matrices (fixed-width ``<U`` numpy
arrays, the datagen's form) take vectorized numpy paths over the host pool
(``common/hostpool.py``, numpy-only workers) with the native factorizer
(``native/``); ragged object columns keep the per-token Python loops. What
computes on the card: CountVectorizerModel's dense counts (a scatter-add
into a float32 (n, vocabulary) tensor, in row chunks), IDF's dense
document frequencies and product, and FeatureHasher's hashing of numeric
tensor columns (the float64 bit patterns the JAX package hashes, by the
same splitmix64, on the tensor's device).

Deviations (the JAX package's): token hashing uses crc32 rather than the
JVM's murmur3_32, and the default stop-word list is the standard English
list rather than a byte-identical copy of the reference's resource file.
"""

from __future__ import annotations

import math
import re
import zlib
from typing import Tuple

import numpy as np
import torch

from flink_ml_tpu_torch.api.stage import Estimator, Model, Transformer
from flink_ml_tpu_torch.common.functions import narrow_uint
from flink_ml_tpu_torch.common.table import Table
from flink_ml_tpu_torch.params.param import (
    BooleanParam,
    FloatParam,
    IntParam,
    ParamValidators,
    StringArrayParam,
    StringParam,
)
from flink_ml_tpu_torch.params.shared import (
    HasCategoricalCols,
    HasInputCol,
    HasInputCols,
    HasNumFeatures,
    HasOutputCol,
    HasOutputCols,
)
from flink_ml_tpu_torch.utils import io as rw

# the standard English stop-word list (Snowball/NLTK lineage)
ENGLISH_STOP_WORDS = (
    "i me my myself we our ours ourselves you your yours yourself yourselves "
    "he him his himself she her hers herself it its itself they them their "
    "theirs themselves what which who whom this that these those am is are "
    "was were be been being have has had having do does did doing a an the "
    "and but if or because as until while of at by for with about against "
    "between into through during before after above below to from up down in "
    "out on off over under again further then once here there when where why "
    "how all any both each few more most other some such no nor not only own "
    "same so than too very s t can will just don should now").split()


def _hash_index(token: str, num_features: int) -> int:
    return zlib.crc32(token.encode("utf-8")) % num_features


def _hash_numeric_bits(values: np.ndarray, salt: int,
                       num_features: int) -> np.ndarray:
    """Vectorized bucket hash for NUMERIC categorical identities.

    A numeric cell's categorical identity is its float64 bit pattern (so
    1 and 1.0 coincide; 0.0 and -0.0 differ), salted with the column name
    and mixed by splitmix64 — no per-value string formatting or Python
    hashing (3 Python calls per distinct value dominated FeatureHasher at
    1M distinct doubles per column). The reference hashes the Java string
    "name=value" with murmur; this hash never matched that bit for bit
    (only internal consistency matters). :func:`_hash_numeric_bits_torch`
    is the same hash on a tensor's device.
    """
    bits = np.ascontiguousarray(values, np.float64).view(np.uint64)
    with np.errstate(over="ignore"):
        z = bits ^ np.uint64(salt)
        z = z + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    return (z % np.uint64(num_features)).astype(np.int64)


def _u64_const(c: int) -> int:
    """A uint64 constant as the int64 of the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's ``>>`` is arithmetic)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _hash_numeric_bits_torch(values: torch.Tensor, salt: int,
                             num_features: int) -> torch.Tensor:
    """:func:`_hash_numeric_bits` on a tensor's device: the float64 bit
    pattern of each value (a float32 tensor widens exactly, as the JAX
    package's host copy does), splitmix64 in int64 arithmetic that wraps
    like uint64, and the unsigned modulo taken over the two 32-bit
    halves."""
    z = values.to(torch.float64).contiguous().view(torch.int64)
    z = z ^ _u64_const(salt)
    z = z + _u64_const(0x9E3779B97F4A7C15)
    z = (z ^ _shr(z, 30)) * _u64_const(0xBF58476D1CE4E5B9)
    z = (z ^ _shr(z, 27)) * _u64_const(0x94D049BB133111EB)
    z = z ^ _shr(z, 31)
    m = int(num_features)
    hi, lo = _shr(z, 32), z & 0xFFFFFFFF
    return ((hi % m) * ((1 << 32) % m) + lo % m) % m


def _materialize_token_cells(col):
    """Token cells may be one-shot iterables; give every cell a len()."""
    if any(not hasattr(t, "__len__") for t in col):
        return [t if hasattr(t, "__len__") else list(t) for t in col]
    return col


def _is_token_matrix(col) -> bool:
    """(n, size) fixed-width string array — the vectorized token-array
    form (RandomStringArrayGenerator, NGram output). Equivalent to an
    object column of equal-length token lists, but one numpy array: the
    text ops' fast paths run np.unique/bincount over it instead of
    per-token Python loops (a 10M x 100 corpus is 1e9 tokens)."""
    return (isinstance(col, np.ndarray) and col.ndim == 2
            and col.dtype.kind == "U")


def _first_appearance_unique(keys: np.ndarray):
    """``(codes, uniq)`` of a 1-D array labelled by first appearance, by
    np.unique: the engine past the native factorizer's distinct cap."""
    uniq, first, inv = np.unique(keys, return_index=True,
                                 return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))
    return rank[inv.reshape(-1)], uniq[order]


def _factorize_view(view: np.ndarray):
    """First-appearance factorization of a 1-D integer key array:
    ``(codes int64, uniq same-dtype-as-view)`` by the native
    open-addressing kernel (``native.factorize_i64``), or np.unique past
    its distinct cap."""
    from flink_ml_tpu_torch import native

    res = native.factorize_i64(view if view.dtype == np.int64
                               else view.astype(np.int64))
    if res is None:
        return _first_appearance_unique(view)
    uniq, codes = res
    return codes, (uniq if view.dtype == np.int64
                   else uniq.astype(view.dtype))


def _factorize_codes(keys: np.ndarray) -> np.ndarray:
    """First-appearance labels only (the wide-token fold's inner engine),
    int64 keys → int64 codes."""
    from flink_ml_tpu_torch import native

    res = native.factorize_i64(keys)
    if res is None:
        return _first_appearance_unique(keys)[0]
    return res[1]


def _token_codes(col: np.ndarray, sort: bool = True):
    """Token matrix → (distinct_tokens, flat_codes): every token visited
    once; per-token Python work then happens once per DISTINCT token only.
    With ``sort=True`` ``distinct_tokens`` is lexicographically sorted
    (the documented tie-break contract); ``sort=False`` leaves the
    distinct set in factorization (first-appearance) order and skips the
    re-rank gather — at 1e8 tokens per shard that gather was ~1.2 s, a
    third of the whole CountVectorizer shard count, and every in-repo
    consumer either gathers THROUGH the codes or re-sorts downstream, so
    they pass sort=False.

    A '<U' itemsize is a whole number of 4-byte code points, so the
    factorization runs over an integer VIEW of the buffer. Tokens of ≤ 8
    bytes go through the native hash-table factorizer — O(N) with no sort
    of the N tokens; wider tokens fold their int32 columns through
    successive factorizes. Other dtypes take np.unique. Either way the
    small distinct set is re-sorted lexicographically and the codes
    re-ranked afterwards when ``sort``."""
    flat = np.ascontiguousarray(col).reshape(-1)
    nints, rem = divmod(flat.dtype.itemsize, 4)
    if flat.dtype.kind != "U" or rem or nints == 0:
        uniq, inv = np.unique(flat, return_inverse=True)
        return uniq, inv.reshape(-1)
    uniq = inv = None
    if nints <= 2:
        view = flat.view("<i4" if nints == 1 else "<i8")
        inv, uniq_v = _factorize_view(view)
        uniq = np.ascontiguousarray(uniq_v).view(flat.dtype).reshape(-1)
    else:
        # wider tokens: fold the int32 columns through successive
        # hash-factorizes — O(nints·N), no sort of the N tokens. Each
        # fold packs (running code, next column) into one
        # int64 key; codes stay < N so the pack never collides.
        cols = flat.view("<i4").reshape(-1, nints)
        # two reused int64 buffers: the running pack key and the
        # current column — per-fold churn is one read+write of each
        # instead of three fresh N-element temporaries
        key = cols[:, 0].astype(np.int64)
        cj = np.empty_like(key)
        codes = _factorize_codes(key)
        for j in range(1, nints):
            np.left_shift(codes, 32, out=key)
            np.copyto(cj, cols[:, j])
            cj &= np.int64(0xFFFFFFFF)
            key |= cj
            codes = _factorize_codes(key)
        # both engines label by FIRST APPEARANCE; recover each
        # code's first index with one reversed scatter (duplicate
        # fancy-index assignments keep the last write = the
        # smallest original index)
        k = int(codes.max()) + 1 if len(codes) else 0
        first = np.empty(k, np.int64)
        first[codes[::-1]] = np.arange(len(codes) - 1, -1, -1)
        uniq, inv = flat[first], codes
    if not sort:
        return uniq, inv.reshape(-1)
    order = np.argsort(uniq)
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))
    return uniq[order], rank[inv.reshape(-1)]


def _rowwise_counts(mat: np.ndarray, with_counts: bool = True,
                    domain: int = None):
    """Per-row value counts of an (n, w) int matrix, fully vectorized.
    Replaces the global ``np.unique(rows * size + flat)`` whose O(N log N)
    argsort dominated the 1e9-token transforms. Returns (row_of, value,
    count) with rows ascending and values ascending within each row
    (CSR-canonical order); count is None with ``with_counts=False``.

    IN-PLACE CONTRACT: the row-sort engine sorts ``mat``'s row chunks in
    place, so callers must pass an owned buffer whose row order they do
    not rely on afterwards (per-row multisets are preserved; within-row
    order is not). Pass ``mat.copy()`` to keep the original intact.

    Three engines, all processing bounded ROW CHUNKS (one giant pass
    thrashes the allocator), after the native counter for domains of at
    most 128 (one pass, CSR-canonical triples, ``mat`` unmodified):
    - tiny ``domain`` (≤ 64): ``domain`` equality-sum passes over the
      matrix — no sort, no key materialization, and ``mat`` is NOT
      modified;
    - small ``domain``: a per-chunk (rows, domain) bincount matrix +
      nonzero — O(N), no sorting;
    - otherwise: in-place row sort + run-length encode per chunk,
      O(n·w·log w) with w the token width (~1e2).
    """
    n, w = mat.shape
    empty = np.zeros(0, np.int64)
    if w == 0:  # zero-width token matrix (NGram n > width, all-stopword)
        return empty, np.zeros(0, mat.dtype), \
            (empty if with_counts else None)

    if domain is not None and 0 < domain <= 128:
        # native stamped per-row counter (the JAX package's split:
        # larger domains keep the vectorized bincount engine). Leaves
        # ``mat`` unmodified, which the in-place contract permits.
        from flink_ml_tpu_torch import native

        res = native.rowwise_counts(mat, domain)
        if res is not None:
            row_of, values, counts = res
            return (row_of, values.astype(mat.dtype, copy=False),
                    counts if with_counts else None)

    row_parts, val_parts, cnt_parts = [], [], []

    if domain is not None and 0 < domain <= 64:
        # k-pass engine: per-row counts ≤ w, so the count matrix can be
        # one byte per cell for the usual token widths. Chunk by
        # max(domain, w): the per-pass ``sub == j`` bool temporary is
        # chunk·w bytes and must stay bounded too.
        cdt = narrow_uint(w + 1)
        chunk = max(1, (64 << 20) // max(domain, w))
        for r0 in range(0, n, chunk):
            r1 = min(r0 + chunk, n)
            sub = mat[r0:r1]
            cnt = np.empty((r1 - r0, domain), cdt)
            for j in range(domain):
                np.sum(sub == j, axis=1, dtype=cdt, out=cnt[:, j])
            rr, vv = np.nonzero(cnt)
            row_parts.append(rr + r0)
            val_parts.append(vv.astype(mat.dtype, copy=False))
            if with_counts:
                cnt_parts.append(cnt[rr, vv])
    elif domain is not None and 0 < domain <= max(4 * w, 1024):
        # bincount engine: chunk so the counts matrix stays ~512 MB
        chunk = max(1, (64 << 20) // domain)
        base = np.arange(min(chunk, n), dtype=np.int64)[:, None] * domain
        for r0 in range(0, n, chunk):
            r1 = min(r0 + chunk, n)
            keys = (base[: r1 - r0] + mat[r0:r1]).reshape(-1)
            cm = np.bincount(keys, minlength=(r1 - r0) * domain) \
                .reshape(r1 - r0, domain)
            rr, vv = np.nonzero(cm)
            row_parts.append(rr + r0)
            val_parts.append(vv.astype(mat.dtype, copy=False))
            if with_counts:
                cnt_parts.append(cm[rr, vv])
    else:
        # row-sort engine: ~64M-element chunks keep every temporary
        # (bool change mask, nonzero output) small enough to recycle
        chunk = max(1, (64 << 20) // w)
        change = np.empty((min(chunk, n), w), np.bool_)
        for r0 in range(0, n, chunk):
            r1 = min(r0 + chunk, n)
            c = mat[r0:r1]
            c.sort(axis=1)
            ch = change[: r1 - r0]
            ch[:, 0] = True
            np.not_equal(c[:, 1:], c[:, :-1], out=ch[:, 1:])
            starts = np.nonzero(ch.reshape(-1))[0]
            row_parts.append(starts // w + r0)
            val_parts.append(c.reshape(-1)[starts])
            if with_counts:
                cnt = np.empty_like(starts)
                np.subtract(starts[1:], starts[:-1], out=cnt[:-1])
                if len(cnt):
                    cnt[-1] = (r1 - r0) * w - starts[-1]
                cnt_parts.append(cnt)

    row_of = np.concatenate(row_parts) if row_parts else empty
    values = np.concatenate(val_parts) if val_parts else \
        np.zeros(0, mat.dtype)
    counts = (np.concatenate(cnt_parts) if cnt_parts else empty) \
        if with_counts else None
    return row_of, values, counts


def _build_sparse_rows(n, size, sorted_row_ids, col_idx, values):
    """See linalg.sparse.build_csr_column (shared with OneHotEncoder):
    the aggregation triples become the CSR buffers directly — no per-row
    SparseVector loop; rows materialize lazily on access."""
    from flink_ml_tpu_torch.linalg.sparse import build_csr_column

    return build_csr_column(n, size, sorted_row_ids, col_idx, values)


def _tokenize_distinct(col: np.ndarray, tokenize):
    """Tokenize a fixed-width '<U' string column by running ``tokenize``
    once per DISTINCT string and gathering — a 10M-row column over a small
    domain pays |distinct| regex/split calls, not 10M. Equal-length token
    lists come back as a vectorized (n, L) token matrix; ragged results
    are an object column whose rows SHARE the per-distinct token list
    (token cells are read-only by convention, like the shared numpy string
    buffers they replace)."""
    n = len(col)
    if n > 4096:
        # dedup only pays when the domain is small; probe a sample — a
        # mostly-distinct free-text column skips the factorize sort and
        # tokenizes row-by-row as before
        sample = col[:: max(1, n // 1024)]
        if len(np.unique(sample)) > len(sample) // 2:
            out = np.empty(n, dtype=object)
            for i, text in enumerate(col):
                out[i] = tokenize(str(text))
            return out
    uniq, codes = _token_codes(col, sort=False)  # flattens; (n,) is fine
    lists = [tokenize(str(s)) for s in uniq]
    lengths = {len(t) for t in lists}
    if len(lengths) == 1 and next(iter(lengths)) > 0:
        return np.asarray(lists)[codes]  # token matrix
    uniq_objs = np.empty(len(lists), dtype=object)
    uniq_objs[:] = lists
    return uniq_objs[codes]


def _merge_token_shards(parts):
    """Merge per-shard tokenization results (host-pool reduce step).

    Equal-width 2-D token matrices vstack back into one matrix (numpy
    promotes differing '<U' itemsizes); anything else — ragged shards,
    object columns, mixed widths across shards — becomes one object
    column. Cells of a matrix shard land as read-only row views, which
    downstream ops treat like the token lists they replace (both are
    sized iterables of strings)."""
    if len(parts) == 1:
        return parts[0]
    if all(isinstance(p, np.ndarray) and p.ndim == 2 for p in parts) \
            and len({p.shape[1] for p in parts}) == 1:
        return np.vstack(parts)
    out = np.empty(sum(len(p) for p in parts), dtype=object)
    k = 0
    for p in parts:
        if isinstance(p, np.ndarray) and p.ndim == 2:
            for row in p:
                out[k] = row
                k += 1
        else:
            out[k:k + len(p)] = p
            k += len(p)
    return out


class Tokenizer(Transformer, HasInputCol, HasOutputCol):
    """Lowercase + whitespace split (ref: feature/tokenizer/Tokenizer.java).

    Fanned over the host pool on row shards (the reference runs every
    string op on defaultParallelism subtasks); each worker lowercases and
    tokenizes its shard, the parent merges (_merge_token_shards)."""

    def transform(self, table: Table) -> Tuple[Table]:
        from flink_ml_tpu_torch.common.hostpool import map_row_shards

        col = table.column(self.input_col)
        if isinstance(col, np.ndarray) and col.dtype.kind == "U" and len(col):
            def shard(lo, hi):
                low = np.char.lower(col[lo:hi])
                # single-token fast path: all-alphanumeric strings contain
                # no whitespace of ANY kind (str.split semantics incl.
                # \r \v \f and unicode spaces) and are non-empty — each is
                # its own token, a vectorized (m, 1) token matrix
                if np.char.isalnum(low).all():
                    return low[:, None]
                return _tokenize_distinct(low, str.split)

            return (table.with_column(
                self.output_col,
                _merge_token_shards(map_row_shards(shard, len(col)))),)

        def shard(lo, hi):
            out = np.empty(hi - lo, dtype=object)
            for i in range(lo, hi):
                out[i - lo] = str(col[i]).lower().split()
            return out

        return (table.with_column(
            self.output_col,
            _merge_token_shards(map_row_shards(shard, len(col)))),)


class RegexTokenizer(Transformer, HasInputCol, HasOutputCol):
    """Regex split/match tokenization (ref: feature/regextokenizer/):
    gaps=True → pattern is the delimiter; gaps=False → pattern matches
    tokens. minTokenLength filters, toLowercase lowercases first.
    Row shards fan over the host pool like Tokenizer."""

    PATTERN = StringParam("pattern", "Regex pattern used for tokenizing.",
                          "\\s+")
    GAPS = BooleanParam(
        "gaps", "Whether the regex splits on gaps (true) or matches tokens "
        "(false).", True)
    MIN_TOKEN_LENGTH = IntParam(
        "minTokenLength", "Minimum token length.", 1,
        ParamValidators.gt_eq(0))
    TO_LOWERCASE = BooleanParam(
        "toLowercase", "Whether to convert all characters to lowercase "
        "before tokenizing.", True)

    def transform(self, table: Table) -> Tuple[Table]:
        from flink_ml_tpu_torch.common.hostpool import map_row_shards

        pattern = re.compile(self.pattern)
        min_len = self.min_token_length
        lower = self.to_lowercase
        gaps = self.gaps

        def tokenize(text):
            if lower:
                text = text.lower()
            tokens = (pattern.split(text) if gaps
                      else pattern.findall(text))
            return [t for t in tokens if len(t) >= min_len]

        col = table.column(self.input_col)
        if isinstance(col, np.ndarray) and col.dtype.kind == "U" and len(col):
            return (table.with_column(
                self.output_col,
                _merge_token_shards(map_row_shards(
                    lambda lo, hi: _tokenize_distinct(col[lo:hi], tokenize),
                    len(col)))),)

        def shard(lo, hi):
            out = np.empty(hi - lo, dtype=object)
            for i in range(lo, hi):
                out[i - lo] = tokenize(str(col[i]))
            return out

        return (table.with_column(
            self.output_col,
            _merge_token_shards(map_row_shards(shard, len(col)))),)


class NGram(Transformer, HasInputCol, HasOutputCol):
    """Space-joined n-grams over a token array (ref: feature/ngram/).
    Row shards fan over the host pool; shard outputs share the uniform
    gram width, so the merge is one vstack."""

    N = IntParam("n", "Number of elements per n-gram (>=1).", 2,
                 ParamValidators.gt_eq(1))

    def transform(self, table: Table) -> Tuple[Table]:
        from flink_ml_tpu_torch.common.hostpool import map_row_shards

        n = self.n
        col = table.column(self.input_col)
        if _is_token_matrix(col):
            # vectorized: n-grams of a token matrix are shifted slices
            # joined with np.char — output is itself a token matrix
            s = col.shape[1]
            if s < n:
                grams = np.empty((len(col), 0), dtype=col.dtype)
                return (table.with_column(self.output_col, grams),)

            def shard(lo, hi):
                sub = col[lo:hi]
                grams = sub[:, : s - n + 1]
                for j in range(1, n):
                    grams = np.char.add(np.char.add(grams, " "),
                                        sub[:, j: s - n + 1 + j])
                return grams

            return (table.with_column(
                self.output_col,
                _merge_token_shards(map_row_shards(shard, len(col)))),)

        def shard(lo, hi):
            out = np.empty(hi - lo, dtype=object)
            for i in range(lo, hi):
                tokens = list(col[i])
                out[i - lo] = [" ".join(tokens[j:j + n])
                               for j in range(len(tokens) - n + 1)]
            return out

        return (table.with_column(
            self.output_col,
            _merge_token_shards(map_row_shards(shard, len(col)))),)


class StopWordsRemover(Transformer, HasInputCols, HasOutputCols):
    """Filter stop words from token arrays (ref: feature/stopwordsremover/ —
    stopWords default English; caseSensitive default false; locale for the
    case-insensitive fold)."""

    STOP_WORDS = StringArrayParam(
        "stopWords", "The words to be filtered out.",
        tuple(ENGLISH_STOP_WORDS))
    CASE_SENSITIVE = BooleanParam(
        "caseSensitive", "Whether to do a case-sensitive comparison over "
        "the stop words.", False)
    LOCALE = StringParam("locale", "Locale of the input for case-insensitive "
                         "matching.", "en_US")

    @staticmethod
    def load_default_stop_words(language: str):
        """Ref API parity: StopWordsRemover.loadDefaultStopWords."""
        if language != "english":
            raise ValueError(f"no built-in stop words for {language!r}; "
                             "set stopWords explicitly")
        return list(ENGLISH_STOP_WORDS)

    @staticmethod
    def _fold(token: str, locale: str) -> str:
        # locale-aware case fold: Turkic locales map I→ı / İ→i
        if locale and locale.split("_")[0] in ("tr", "az"):
            token = token.replace("İ", "i").replace("I", "ı")
        return token.lower()

    @classmethod
    def _allowed_first_cps(cls, stop, locale: str, case_sensitive: bool):
        """BMP code points a token may START with and still possibly be a
        stop word — the prefilter domain for :meth:`transform`'s
        first-character screen.  Computed by inverting the fold over the
        whole BMP (one 65k scan, cached per stop set): cp is allowed iff
        fold(chr(cp)) begins with the first char of some stop word.
        Astral first chars (>0xFFFF) are handled conservatively by the
        caller (always candidates)."""
        key = (frozenset(stop), locale if not case_sensitive else None)
        cached = cls._ALLOWED_CACHE.get(key)
        if cached is not None:
            return cached
        firsts = {w[0] for w in stop if w}
        if case_sensitive:
            cps = sorted(ord(c) for c in firsts)
        else:
            cps = sorted(
                cp for cp in range(0x10000)
                if (cls._fold(chr(cp), locale) or "\0")[0] in firsts)
        if "" in stop:  # '' tokens are all-zero '<U' buffers (first cp 0)
            cps = sorted(set(cps) | {0})
        allowed = np.array(cps, np.int32)
        cls._ALLOWED_CACHE[key] = allowed
        return allowed

    _ALLOWED_CACHE: dict = {}

    def transform(self, table: Table) -> Tuple[Table]:
        from flink_ml_tpu_torch.common.hostpool import map_row_shards

        if self.case_sensitive:
            stop = set(self.stop_words)
            keep = lambda t: t not in stop
        else:
            locale = self.locale
            stop = {self._fold(w, locale) for w in self.stop_words}
            keep = lambda t: self._fold(t, locale) not in stop
        outs = {}
        for name, out_name in zip(self.input_cols, self.output_cols):
            col = table.column(name)
            out = np.empty(len(col), dtype=object)
            if _is_token_matrix(col) and col.dtype.itemsize % 4 == 0 \
                    and col.dtype.itemsize > 0:
                # first-character screen: a token can only be a stop word
                # if its first code point folds onto some stop word's
                # first char.  One int32 pass over the raw '<U' buffer
                # finds the candidate tokens; only those pay the
                # fold-and-compare.  A corpus with no candidates (e.g.
                # numeric-string tokens) is an O(n) identity.  The screen
                # and the per-distinct fold fan over the host pool on row
                # shards; each worker returns its shard's keep mask (None
                # = nothing to remove) and the parent assembles the
                # output representation once, globally.
                n_r, w_r = col.shape
                nints = col.dtype.itemsize // 4
                allowed = self._allowed_first_cps(
                    stop, self.locale, self.case_sensitive)
                stop_sorted = np.array(sorted(stop))
                case_sensitive, locale_ = self.case_sensitive, self.locale
                fold = self._fold

                def shard(lo, hi):
                    sub = col[lo:hi]
                    first = sub.view("<i4").reshape(
                        hi - lo, w_r, nints)[:, :, 0]
                    cand = np.isin(first, allowed) | (first > 0xFFFF)
                    cand_flat = cand.reshape(-1)
                    if not cand_flat.any():
                        return hi - lo, None  # all kept: no mask payload
                    # fold/compare ONLY the candidate tokens, per distinct
                    cand_tokens = sub.reshape(-1)[cand_flat]
                    cu, cc = _token_codes(cand_tokens, sort=False)
                    cfold = (cu if case_sensitive else np.array(
                        [fold(str(t), locale_) for t in cu]))
                    is_stop = np.isin(cfold, stop_sorted)[cc]
                    if not is_stop.any():
                        return hi - lo, None
                    kf = np.ones((hi - lo) * w_r, np.bool_)
                    kf[cand_flat] = ~is_stop
                    return hi - lo, kf

                parts = map_row_shards(shard, n_r)
                if all(kf is None for _, kf in parts):
                    outs[out_name] = col
                    continue
                keep_flat = np.concatenate(
                    [kf if kf is not None
                     else np.ones(rows * w_r, np.bool_)
                     for rows, kf in parts])
                if keep_flat.all():
                    # nothing filtered: the input token matrix IS the
                    # output (the benchmark corpus of numeric-string
                    # tokens hits this; no 1M-row np.split)
                    outs[out_name] = col
                    continue
                counts = keep_flat.reshape(col.shape).sum(axis=1)
                kept = col.reshape(-1)[keep_flat]
                if (counts == counts[0]).all():
                    # uniform removals keep the vectorized representation
                    outs[out_name] = kept.reshape(len(col), int(counts[0]))
                    continue
                # ragged → object column of arrays, assembled as one flat
                # filter + np.split (no per-row boolean indexing)
                out[:] = np.split(kept, np.cumsum(counts[:-1]))
                outs[out_name] = out
                continue
            def obj_shard(lo, hi):
                part = np.empty(hi - lo, dtype=object)
                for i in range(lo, hi):
                    part[i - lo] = [t for t in col[i] if keep(t)]
                return part

            outs[out_name] = _merge_token_shards(
                map_row_shards(obj_shard, len(col)))
        return (table.with_columns(**outs),)


class HashingTF(Transformer, HasInputCol, HasOutputCol, HasNumFeatures):
    """Hash token arrays into fixed-size term-frequency vectors
    (ref: feature/hashingtf/ — numFeatures default 262144; binary flag)."""

    BINARY = BooleanParam(
        "binary", "Whether each dimension of the output vector is binary "
        "(1 when the term occurs) or the term frequency.", False)

    def transform(self, table: Table) -> Tuple[Table]:
        m = self.num_features
        col = table.column(self.input_col)
        n = len(col)
        # hash each distinct token once; then aggregate (row, bucket) pairs
        # with one vectorized unique instead of a dict per row — fanned
        # over the host pool on row shards (each worker returns GLOBAL-row
        # triples; the parent concatenates and builds ONE CSR column)
        if _is_token_matrix(col):
            from flink_ml_tpu_torch.common.hostpool import map_row_shards

            def shard(lo, hi):
                sub = col[lo:hi]
                uniq, codes = _token_codes(sub, sort=False)
                buckets = np.fromiter(
                    (_hash_index(str(t), m) for t in uniq),
                    np.int64, len(uniq))
                # count over the DISTINCT-BUCKET alphabet, not the 2^18
                # bucket domain: tokens hashing to one bucket share a
                # label (collisions merge inside the count), the
                # relabeled matrix is 1-2 bytes/cell instead of 8 (this
                # host punishes big working sets 5-20x), and ascending
                # labels stay ascending buckets (CSR-canonical)
                ub, inv = np.unique(buckets, return_inverse=True)
                row_of, ub_idx, counts = _rowwise_counts(
                    inv.astype(narrow_uint(len(ub)))[codes]
                       .reshape(sub.shape),
                    domain=len(ub))
                return row_of + lo, ub[ub_idx], counts

            parts = map_row_shards(shard, n)
            row_of = np.concatenate([p[0] for p in parts])
            bucket = np.concatenate([p[1] for p in parts])
            counts = np.concatenate([p[2] for p in parts])
            values = (np.ones(len(bucket)) if self.binary
                      else counts.astype(np.float64))
            out = _build_sparse_rows(n, m, row_of, bucket, values)
            return (table.with_column(self.output_col, out),)
        col = _materialize_token_cells(col)
        lengths = np.fromiter((len(t) for t in col), np.int64, n)
        total = int(lengths.sum())
        flat_idx = np.empty(total, np.int64)
        cache = {}
        k = 0
        for tokens in col:
            for t in tokens:
                s = str(t)
                h = cache.get(s)
                if h is None:
                    h = _hash_index(s, m)
                    cache[s] = h
                flat_idx[k] = h
                k += 1
        rows = np.repeat(np.arange(n, dtype=np.int64), lengths)
        key, counts = np.unique(rows * m + flat_idx, return_counts=True)
        values = (np.ones(len(key)) if self.binary
                  else counts.astype(np.float64))
        out = _build_sparse_rows(n, m, key // m, key % m, values)
        return (table.with_column(self.output_col, out),)


class FeatureHasher(Transformer, HasInputCols, HasOutputCol, HasNumFeatures,
                    HasCategoricalCols):
    """Hash mixed numeric/categorical columns into one vector
    (ref: feature/featurehasher/): numeric column → index hash(colName) with
    the value; categorical (string/bool or listed in categoricalCols) →
    index hash("colName=value") with 1.0."""

    def transform(self, table: Table) -> Tuple[Table]:
        m = self.num_features
        n = table.num_rows
        categorical = set(self.categorical_cols or ())
        raw = {name: table.column(name) for name in self.input_cols}
        if raw and all(isinstance(c, torch.Tensor) and c.ndim == 1
                       and c.dtype != torch.bool and not c.is_complex()
                       for c in raw.values()):
            # numeric tensor columns: hash on their device
            out = self._hash_rows_device(raw, categorical, m, n)
            return (table.with_column(self.output_col, out),)
        cols = {name: (c.cpu().numpy() if isinstance(c, torch.Tensor)
                       else np.asarray(c))
                for name, c in raw.items()}
        from flink_ml_tpu_torch.common.hostpool import map_row_shards

        def shard(lo, hi):
            row_of, bucket, sums = self._hash_rows(cols, categorical, m,
                                                   lo, hi)
            return row_of + lo, bucket, sums

        parts = map_row_shards(shard, n)
        out = _build_sparse_rows(
            n, m,
            np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]),
            np.concatenate([p[2] for p in parts]))
        return (table.with_column(self.output_col, out),)

    def _hash_rows_device(self, cols, categorical, m, n):
        """:meth:`_hash_rows` over numeric tensor columns, on their device:
        a numeric column's entry is (hash of its name, its value as
        float64), a categorical one's (the bits-hash of its float64
        value, 1.0). Each row's k entries are sorted by bucket (stable)
        and equal buckets summed left to right, as ``np.add.reduceat``
        sums them; only the CSR buffers come to the host."""
        import scipy.sparse as sp

        from flink_ml_tpu_torch.linalg.sparse import CsrVectorColumn

        device = next(iter(cols.values())).device
        idx_cols, val_cols = [], []
        for name in self.input_cols:
            x = cols[name].to(torch.float64)
            if name not in categorical:
                idx_cols.append(torch.full((n,), _hash_index(name, m),
                                           dtype=torch.int64, device=device))
                val_cols.append(x)
            else:
                salt = zlib.crc32(name.encode("utf-8"))
                idx_cols.append(_hash_numeric_bits_torch(x, salt, m))
                val_cols.append(torch.ones(n, dtype=torch.float64,
                                           device=device))
        k = len(idx_cols)
        bucket, order = torch.sort(torch.stack(idx_cols, dim=1), dim=1,
                                   stable=True)
        acc = torch.gather(torch.stack(val_cols, dim=1), 1, order)
        same = bucket[:, 1:] == bucket[:, :-1]
        for j in range(1, k):
            acc[:, j] += torch.where(same[:, j - 1], acc[:, j - 1], 0.0)
        ends = torch.ones_like(bucket, dtype=torch.bool)
        ends[:, :-1] = ~same
        per_row = ends.sum(dim=1)
        flat = ends.reshape(-1)
        indices = bucket.reshape(-1)[flat].cpu().numpy()
        data = acc.reshape(-1)[flat].cpu().numpy()
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(per_row.cpu().numpy(), out=indptr[1:])
        return CsrVectorColumn(sp.csr_matrix((data, indices, indptr),
                                             shape=(n, m)))

    def _hash_rows(self, cols, categorical, m, lo, hi):
        """Hash rows [lo, hi) of the input columns into shard-local
        (row, bucket, value-sum) triples — the per-worker body of the
        host-pool fan-out."""
        n = hi - lo

        # per column: an (n,) int64 bucket array + an (n,) float64 value
        # array; numeric columns hash their NAME once, categorical columns
        # hash each distinct "name=value" once
        idx_cols, val_cols = [], []
        for name in self.input_cols:
            col = cols[name][lo:hi]
            numeric_dtype = (col.dtype != object
                             and not col.dtype.kind in ("U", "S", "b"))
            if name not in categorical and numeric_dtype:
                # whole column numeric: one name hash, vectorized values
                idx_cols.append(np.full(n, _hash_index(name, m), np.int64))
                val_cols.append(np.asarray(col, np.float64))
                continue
            force_cat = name in categorical
            name_salt = zlib.crc32(name.encode("utf-8"))
            if col.dtype != object:
                if col.dtype.kind in "iuf":
                    # forced-categorical numerics: one vectorized
                    # bits-hash over the whole column — no distinct set,
                    # no per-value Python
                    idx_cols.append(_hash_numeric_bits(col, name_salt, m))
                    val_cols.append(np.ones(n))
                    continue
                # strings/bools: hash each DISTINCT value once, one gather
                uniq, inv = np.unique(col, return_inverse=True)
                buckets = np.fromiter(
                    (_hash_index(f"{name}={v}", m) for v in uniq),
                    np.int64, len(uniq))
                idx_cols.append(buckets[inv.reshape(-1)])
                val_cols.append(np.ones(n))
                continue
            # object column: classify per value — mixed numeric/string
            # cells keep their semantics; numeric-categorical cells use
            # the same bits-hash as the homogeneous branch (one batched
            # call, not per cell) so one value buckets identically in
            # either column representation
            cache = {}
            name_idx = _hash_index(name, m)
            idx = np.empty(n, np.int64)
            vals = np.empty(n)
            strlike = np.fromiter(
                (isinstance(v, (str, bool, np.bool_)) for v in col),
                np.bool_, n)
            for i in np.nonzero(strlike)[0]:
                s = f"{name}={col[i]}"
                h = cache.get(s)
                if h is None:
                    h = _hash_index(s, m)
                    cache[s] = h
                idx[i], vals[i] = h, 1.0
            num_pos = np.nonzero(~strlike)[0]
            if len(num_pos):
                nums = np.asarray([float(col[i]) for i in num_pos],
                                  np.float64)
                if force_cat:
                    idx[num_pos] = _hash_numeric_bits(nums, name_salt, m)
                    vals[num_pos] = 1.0
                else:
                    idx[num_pos] = name_idx
                    vals[num_pos] = nums
            idx_cols.append(idx)
            val_cols.append(vals)

        # sum values per (row, bucket) — collisions within a row accumulate.
        # Each row has exactly k = len(inputCols) entries, so the grouping
        # is a per-row sort of width k (tiny) + segment sums — not a global
        # sort of n·k keys.
        k = len(idx_cols)
        bucket_mat = np.stack(idx_cols, axis=1)
        val_mat = np.stack(val_cols, axis=1)
        order = np.argsort(bucket_mat, axis=1, kind="stable")
        bucket_sorted = np.take_along_axis(bucket_mat, order, axis=1)
        val_sorted = np.take_along_axis(val_mat, order, axis=1)
        change = np.empty((n, k), np.bool_)
        change[:, 0] = True
        np.not_equal(bucket_sorted[:, 1:], bucket_sorted[:, :-1],
                     out=change[:, 1:])
        starts = np.flatnonzero(change.reshape(-1))
        sums = np.add.reduceat(val_sorted.reshape(-1), starts)
        return starts // k, bucket_sorted.reshape(-1)[starts], sums


# ---------------------------------------------------------------------------
# CountVectorizer
# ---------------------------------------------------------------------------

class CountVectorizerModelParams(HasInputCol, HasOutputCol):
    MIN_TF = FloatParam(
        "minTF", "Filter to ignore rare words in a document (count or "
        "fraction of the document's token count when < 1).", 1.0,
        ParamValidators.gt_eq(0.0))
    BINARY = BooleanParam(
        "binary", "Binary toggle to control the output vector values.", False)


class CountVectorizerParams(CountVectorizerModelParams):
    VOCABULARY_SIZE = IntParam(
        "vocabularySize", "Max size of the vocabulary.", 1 << 18,
        ParamValidators.gt(0))
    MIN_DF = FloatParam(
        "minDF", "Minimum number (or fraction) of documents a term must "
        "appear in to be included.", 1.0, ParamValidators.gt_eq(0.0))
    MAX_DF = FloatParam(
        "maxDF", "Maximum number (or fraction) of documents a term may "
        "appear in to be included.", 2 ** 63 - 1, ParamValidators.gt_eq(0.0))


#: index elements per scatter chunk of the dense device counts: the int64
#: index temporary of one chunk stays at 256 MiB (the shipped config's
#: 10,000,000 x 100 ids would be an 8 GB index in one piece)
_SCATTER_CHUNK_ELEMS = 32 << 20


def _device_token_counts(ids1: np.ndarray, u: int, min_tf: float,
                         binary: bool, w: int, device) -> torch.Tensor:
    """CountVectorizerModel's dense transform on ``device``: per-row token
    counts as a scatter-add into a float32 (n, u) tensor, taken in row
    chunks so the int64 index temporary stays bounded. ``ids1`` is the host
    (n, w) matrix of vocabulary ids plus one (0 = out of vocabulary) in the
    narrowest unsigned dtype (or a uint8 tensor already on the card); each
    chunk crosses to the card in that dtype and widens there. An out-of-vocabulary token adds 0 at column 0. The
    minTF threshold and the binary flag apply in place. The counts are
    integers below 2^24, so the float32 sums are exact in any order."""
    n = ids1.shape[0]
    counts = torch.zeros((n, u), dtype=torch.float32, device=device)
    if n == 0 or w == 0 or u == 0:
        return counts
    rows = max(1, _SCATTER_CHUNK_ELEMS // w)
    if ids1.dtype == np.uint16:  # torch has no uint16 arithmetic
        ids1 = ids1.view(np.int16)
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        chunk = ids1[r0:r1] if isinstance(ids1, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(ids1[r0:r1]))
        idx = chunk.to(device).to(torch.int64)
        if chunk.dtype == torch.int16:
            idx &= 0xFFFF
        idx -= 1
        present = (idx >= 0).to(torch.float32)
        counts[r0:r1].scatter_add_(1, idx.clamp_(min=0), present)
        del chunk, idx, present
    # counts are integers, so the float64 host comparison `count >= thr`
    # (the host CSR path) is exactly `count >= ceil(thr)`: an integer
    # threshold the float32 compare cannot round differently
    thr = math.ceil(min_tf if min_tf >= 1.0 else min_tf * w)
    if binary:
        return (counts >= thr).to(torch.float32)
    return counts.masked_fill_(counts < thr, 0.0)


#: dense device-count budget: above this many output bytes the transform
#: keeps the host CSR path (sparse is the right layout for big vocabs)
_DENSE_COUNTS_MAX_BYTES = 4 << 30


def _dense_counts_budget() -> int:
    import os

    env = os.environ.get("FLINK_ML_TPU_DENSE_COUNTS_MAX_BYTES")
    return int(env) if env else _DENSE_COUNTS_MAX_BYTES


class CountVectorizerModel(Model, CountVectorizerModelParams):
    def __init__(self, vocabulary=None, **kwargs):
        super().__init__(**kwargs)
        self.vocabulary = None if vocabulary is None else list(vocabulary)

    def transform(self, table: Table) -> Tuple[Table]:
        if self.vocabulary is None:
            raise ValueError("CountVectorizerModel has no model data")
        index = {t: i for i, t in enumerate(self.vocabulary)}
        size = len(self.vocabulary)
        col = table.column(self.input_col)
        n = len(col)
        # flat pass: vocab id per token (-1 = OOV), then one vectorized
        # aggregation — same bulk shape as HashingTF.transform
        min_tf = self.min_tf
        if _is_token_matrix(col):
            # both branches fan over the host pool on row shards (workers
            # are numpy-only; the device scatter below runs in the parent): each worker factorizes its shard and maps distinct
            # tokens through the vocab index ONCE per shard-distinct
            from flink_ml_tpu_torch.common.hostpool import map_row_shards

            w = col.shape[1]
            if (size + 1 < (1 << 16)
                    and n * size * 4 <= _dense_counts_budget()):
                # small vocab → dense (n, size) f32 counts on the card
                # (the JAX package's deviation: a dense device column
                # where the reference emits SparseVector)
                dt = narrow_uint(size + 2)

                def dense_shard(lo, hi):
                    uniq, codes = _token_codes(col[lo:hi], sort=False)
                    vocab_ids = np.fromiter(
                        (index.get(str(t), -1) for t in uniq),
                        np.int64, len(uniq))
                    return (vocab_ids + 1).astype(dt)[codes] \
                        .reshape(hi - lo, w)

                ids1 = np.concatenate(map_row_shards(dense_shard, n))
                out = _device_token_counts(ids1, size, min_tf,
                                           self.binary, w, self.device)
                return (table.with_column(self.output_col, out),)

            def csr_shard(lo, hi):
                # count over codes RANKED by vocab id (small domain → the
                # bincount engine applies) — run values map back to vocab
                # ids still ascending within each row; OOV (-1) ranks
                # first. Per-shard triples are CSR-canonical and rows are
                # shard-ordered, so concatenation stays canonical.
                sub = col[lo:hi]
                uniq, codes = _token_codes(sub, sort=False)
                vocab_ids = np.fromiter(
                    (index.get(str(t), -1) for t in uniq),
                    np.int64, len(uniq))
                u = len(uniq)
                order = np.argsort(vocab_ids, kind="stable")
                rank_of_code = np.empty(u, np.int64)
                rank_of_code[order] = np.arange(u)
                row_of, rank, counts = _rowwise_counts(
                    rank_of_code[codes].reshape(sub.shape), domain=u)
                vocab_id = vocab_ids[order][rank]
                in_vocab = vocab_id >= 0  # OOV runs sort first per row
                row_of, vocab_id, counts = (row_of[in_vocab],
                                            vocab_id[in_vocab],
                                            counts[in_vocab])
                thresholds = min_tf if min_tf >= 1.0 else min_tf * w
                keep = counts >= thresholds
                return (row_of[keep] + lo, vocab_id[keep], counts[keep])

            parts = map_row_shards(csr_shard, n)
            row_of = np.concatenate([p[0] for p in parts])
            vocab_id = np.concatenate([p[1] for p in parts])
            counts = np.concatenate([p[2] for p in parts])
            values = np.ones(len(vocab_id)) if self.binary \
                else counts.astype(np.float64)
            out = _build_sparse_rows(n, size, row_of, vocab_id, values)
            return (table.with_column(self.output_col, out),)
        col = _materialize_token_cells(col)
        lengths = np.fromiter((len(t) for t in col), np.int64, n)
        flat = np.empty(int(lengths.sum()), np.int64)
        k = 0
        for tokens in col:
            for t in tokens:
                flat[k] = index.get(str(t), -1)
                k += 1
        rows = np.repeat(np.arange(n, dtype=np.int64), lengths)
        in_vocab = flat >= 0
        key, counts = np.unique(rows[in_vocab] * size + flat[in_vocab],
                                return_counts=True)
        row_of = key // size
        thresholds = (np.full(len(key), min_tf) if min_tf >= 1.0
                      else min_tf * lengths[row_of])
        keep = counts >= thresholds
        key, counts, row_of = key[keep], counts[keep], row_of[keep]
        values = np.ones(len(key)) if self.binary \
            else counts.astype(np.float64)
        out = _build_sparse_rows(n, size, row_of, key % size, values)
        return (table.with_column(self.output_col, out),)

    def set_model_data(self, model_data: Table):
        self.vocabulary = [str(t) for t in model_data.column("vocabulary")]
        return self

    def get_model_data(self) -> Tuple[Table]:
        return (Table.from_columns(
            vocabulary=np.asarray(self.vocabulary, dtype=object)),)

    def _save_extra(self, path: str) -> None:
        rw.save_model_json(path, "model", {"vocabulary": self.vocabulary})

    def _load_extra(self, path: str, meta: dict) -> None:
        self.vocabulary = rw.load_model_json(path, "model")["vocabulary"]


def _doc_freq_small_domain(codes_mat: np.ndarray, u: int,
                           chunk_elems: int = 512 << 10) -> np.ndarray:
    """Document frequency over an (n, w) code matrix with domain
    ``[0, u)``: per-chunk (rows, u) bincount matrix, then a per-column
    nonzero count — no row-of/value triple is ever materialized.  4×
    faster than routing through :func:`_rowwise_counts` (whose nonzero +
    fancy-gather steps exist to build CSR triples the fit never needs).
    Chunks sized to keep the count matrix cache-resident."""
    n, w = codes_mat.shape
    if u == 0 or w == 0 or n == 0:  # empty domain / zero-width matrix
        return np.zeros(u, np.int64)
    chunk = max(1, chunk_elems // max(1, u))
    base = np.arange(min(chunk, n), dtype=np.int64)[:, None] * u
    df = np.zeros(u, np.int64)
    for r0 in range(0, n, chunk):
        r1 = min(r0 + chunk, n)
        keys = (base[: r1 - r0] + codes_mat[r0:r1]).reshape(-1)
        cm = np.bincount(keys, minlength=(r1 - r0) * u).reshape(-1, u)
        df += np.count_nonzero(cm, axis=0)
    return df


def _cv_shard_counts(col: np.ndarray, lo: int, hi: int):
    """Per-shard CountVectorizer partial: (tokens, term counts, doc freqs)
    over rows [lo, hi) of a token matrix — the per-task count map of the
    reference's dictionary-learning shape (StringIndexer.java:117-122),
    merged by :func:`_merge_shard_counts`."""
    from flink_ml_tpu_torch import native

    shard = col[lo:hi]
    uniq, codes = _token_codes(shard, sort=False)
    u = len(uniq)
    tc = np.bincount(codes, minlength=u)
    mat = codes.reshape(shard.shape)
    df = native.doc_freq_i64(mat, u)  # stamped pass, u-capped (None above)
    if df is None:
        # same width-relative gate as _rowwise_counts: the dense
        # count-matrix pass is O(n·u), only beats row-sort while u ~ O(w)
        if u <= max(4 * shard.shape[1], 1024):
            df = _doc_freq_small_domain(mat, u)
        else:  # huge vocab: row-sorted run starts, one per (doc, token)
            # pair (mat is freshly owned — the in-place row sort is fine)
            _, start_codes, _ = _rowwise_counts(mat, with_counts=False)
            df = np.bincount(start_codes, minlength=u)
    return uniq, tc, df


def _merge_shard_counts(parts):
    """Reduce-merge of per-shard (tokens, tc, df) — the reference's
    DataStreamUtils.reduce map merge (StringIndexer.java:125-142).
    Always returns tokens lexicographically sorted: the shards factorize
    unsorted (sort=False), and the vocabulary's frequency-desc/token-asc
    tie-break downstream depends on ascending token order."""
    if len(parts) == 1:
        uniq, tc, df = parts[0]
        order = np.argsort(uniq)
        return uniq[order], tc[order], df[order]
    all_uniq = np.concatenate([p[0] for p in parts])
    uniq, inv = np.unique(all_uniq, return_inverse=True)
    tc = np.zeros(len(uniq), np.int64)
    df = np.zeros(len(uniq), np.int64)
    k = 0
    for pu, ptc, pdf in parts:
        idx = inv[k:k + len(pu)]
        np.add.at(tc, idx, ptc)
        np.add.at(df, idx, pdf)
        k += len(pu)
    return uniq, tc, df


class CountVectorizer(Estimator, CountVectorizerParams):
    """Learn a frequency-ordered vocabulary from token arrays
    (ref: feature/countvectorizer/ — terms ordered by corpus frequency desc,
    filtered by minDF/maxDF as counts (≥1) or fractions (<1), truncated to
    vocabularySize)."""

    def fit(self, table: Table) -> CountVectorizerModel:
        col = table.column(self.input_col)
        n_docs = len(col)
        if _is_token_matrix(col):
            # vectorized, fanned over the host pool (fork shares the token
            # matrix copy-on-write; each worker returns a per-shard count
            # map, merged reduce-style — the reference's parallel shape)
            from flink_ml_tpu_torch.common.hostpool import map_row_shards

            uniq, tc, df = _merge_shard_counts(map_row_shards(
                lambda lo, hi: _cv_shard_counts(col, lo, hi), n_docs))
            min_df = self.min_df if self.min_df >= 1.0 \
                else self.min_df * n_docs
            max_df = self.max_df if self.max_df >= 1.0 \
                else self.max_df * n_docs
            keep = (df >= min_df) & (df <= max_df)
            kept, kept_tc = uniq[keep], tc[keep]
            # frequency desc, token asc — np.unique already sorted tokens
            # ascending, and stable argsort keeps that order within ties
            order = np.argsort(-kept_tc, kind="stable")
            vocab = [str(t) for t in kept[order][: self.vocabulary_size]]
        else:
            term_count, doc_freq = {}, {}
            for tokens in col:
                seen = set()
                for t in tokens:
                    t = str(t)
                    term_count[t] = term_count.get(t, 0) + 1
                    if t not in seen:
                        seen.add(t)
                        doc_freq[t] = doc_freq.get(t, 0) + 1
            min_df = self.min_df if self.min_df >= 1.0 \
                else self.min_df * n_docs
            max_df = self.max_df if self.max_df >= 1.0 \
                else self.max_df * n_docs
            terms = [t for t in term_count
                     if min_df <= doc_freq[t] <= max_df]
            terms.sort(key=lambda t: (-term_count[t], t))
            vocab = terms[: self.vocabulary_size]
        model = CountVectorizerModel(vocabulary=vocab, device=self._device)
        return self.copy_params_to(model)


# ---------------------------------------------------------------------------
# IDF
# ---------------------------------------------------------------------------

class IDFModelParams(HasInputCol, HasOutputCol):
    pass


class IDFParams(IDFModelParams):
    MIN_DOC_FREQ = IntParam(
        "minDocFreq", "Minimum number of documents in which a term should "
        "appear for filtering.", 0, ParamValidators.gt_eq(0))


def _idf_kernel(x, idf):
    return x * idf[None, :]


class IDFModel(Model, IDFModelParams):
    def __init__(self, idf=None, doc_freq=None, num_docs=0, **kwargs):
        super().__init__(**kwargs)
        self.idf = None if idf is None else np.asarray(idf, np.float64)
        self.doc_freq = (None if doc_freq is None
                         else np.asarray(doc_freq, np.int64))
        self.num_docs = int(num_docs)

    def transform(self, table: Table) -> Tuple[Table]:
        if self.idf is None:
            raise ValueError("IDFModel has no model data")
        from flink_ml_tpu_torch.linalg import sparse as sp_mod

        col = table.column(self.input_col)
        if sp_mod.is_sparse_column(col):
            # O(nnz), never densified: scale stored values by their
            # column's idf, structure shared (a 2^18-dim HashingTF/CV
            # output would be 20 TB dense at 10M rows)
            import scipy.sparse as sp

            m = sp_mod.column_to_csr(col)
            if m.shape[1] != self.idf.shape[0]:
                raise ValueError(
                    f"input vectors have size {m.shape[1]}, model idf has "
                    f"{self.idf.shape[0]}")
            scaled = sp.csr_matrix(
                (m.data * self.idf[m.indices], m.indices, m.indptr),
                shape=m.shape)
            return (table.with_column(self.output_col,
                                      sp_mod.CsrVectorColumn(scaled)),)
        from flink_ml_tpu_torch.ops import columnar

        x = columnar.input_vectors(table, self.input_col, self.device)
        out = columnar.apply(_idf_kernel, x, (self.idf,), (), self.device)
        return (table.with_column(self.output_col, out),)

    def set_model_data(self, model_data: Table):
        self.idf = model_data.vectors("idf", np.float64)[0]
        self.doc_freq = model_data.vectors("docFreq", np.float64)[0].astype(
            np.int64)
        self.num_docs = int(model_data.scalars("numDocs")[0])
        return self

    def get_model_data(self) -> Tuple[Table]:
        return (Table.from_columns(
            idf=self.idf[None, :],
            docFreq=self.doc_freq.astype(np.float64)[None, :],
            numDocs=np.asarray([self.num_docs], np.float64)),)

    def _save_extra(self, path: str) -> None:
        rw.save_model_arrays(path, "model", {
            "idf": self.idf, "docFreq": self.doc_freq,
            "numDocs": np.asarray([self.num_docs])})

    def _load_extra(self, path: str, meta: dict) -> None:
        arrays = rw.load_model_arrays(path, "model")
        self.idf, self.doc_freq = arrays["idf"], arrays["docFreq"]
        self.num_docs = int(arrays["numDocs"][0])


class IDF(Estimator, IDFParams):
    """Inverse document frequency: idf = log((m+1)/(df+1)); dims with
    df < minDocFreq get idf 0 (ref: feature/idf/IDF.java)."""

    def fit(self, table: Table) -> IDFModel:
        from flink_ml_tpu_torch.linalg import sparse as sp_mod

        col = table.column(self.input_col)
        if sp_mod.is_sparse_column(col):
            csr = sp_mod.column_to_csr(col)
            m = csr.shape[0]
            # document frequency per dim = nonzero STORED values per column
            df = np.bincount(csr.indices,
                             weights=(csr.data != 0).astype(np.float64),
                             minlength=csr.shape[1])
        else:
            from flink_ml_tpu_torch.ops import columnar

            x, xp = columnar.fit_vectors(table, self.input_col)
            m = x.shape[0]
            if xp is not np:  # a tensor column: df where it lives
                df = (x != 0).sum(dim=0).cpu().numpy().astype(np.float64)
            else:
                df = (x != 0).sum(axis=0)
        idf = np.log((m + 1.0) / (df + 1.0))
        idf = np.where(df >= self.min_doc_freq, idf, 0.0)
        model = IDFModel(idf=idf, doc_freq=df.astype(np.int64), num_docs=m,
                         device=self._device)
        return self.copy_params_to(model)
