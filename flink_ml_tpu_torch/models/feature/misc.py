"""Imputer, RandomSplitter, SQLTransformer, MinHashLSH.

The port of ``flink_ml_tpu/models/feature/misc.py`` (ref: flink-ml-lib
feature/{imputer,randomsplitter,sqltransformer,lsh}/).

Tensor columns stay where they are: Imputer computes its statistics there
(the mean in float64, the median by ``kthvalue``, the most frequent value
by ``unique``) and replaces missing values there; SQLTransformer's
vectorized evaluator runs its expressions as torch operations on the
columns' device. The sqlite path, for statements outside that grammar,
runs on host copies of the columns, as the JAX package does. MinHashLSH
and RandomSplitter keep the JAX package's host math and draws.
"""

from __future__ import annotations

import math
import operator
import sqlite3
from typing import List, Optional, Tuple

import numpy as np
import torch

from flink_ml_tpu_torch.api.stage import AlgoOperator, Estimator, Model, Transformer
from flink_ml_tpu_torch.common.table import Table
from flink_ml_tpu_torch.linalg.vectors import DenseVector, SparseVector, Vector
from flink_ml_tpu_torch.params.param import (
    FloatArrayParam,
    FloatParam,
    IntParam,
    ParamValidators,
    StringParam,
)
from flink_ml_tpu_torch.params.shared import (
    HasHandleInvalid,
    HasInputCol,
    HasInputCols,
    HasOutputCol,
    HasOutputCols,
    HasRelativeError,
    HasSeed,
)
from flink_ml_tpu_torch.utils import io as rw


def _missing_mask(vals, mv: float):
    """Where ``vals`` (an array or a tensor) holds the missing value. NaN
    matches any NaN; otherwise the comparison is the float64 one of the
    JAX package's host path: on a float32 tensor a value that float32
    cannot hold matches nothing, and one it can is compared in float32
    (the same answer, without a float64 copy)."""
    if isinstance(vals, torch.Tensor):
        if math.isnan(mv):
            return torch.isnan(vals)
        if vals.dtype == torch.float32 and float(np.float32(mv)) != mv:
            return torch.zeros_like(vals, dtype=torch.bool)
        return vals == mv
    if np.isnan(mv):
        return np.isnan(vals)
    return vals == mv


# ---------------------------------------------------------------------------
# Imputer
# ---------------------------------------------------------------------------

class ImputerModelParams(HasInputCols, HasOutputCols):
    MISSING_VALUE = FloatParam(
        "missingValue", "The placeholder for missing values (NaN matches "
        "any NaN).", float("nan"))


class ImputerParams(ImputerModelParams, HasRelativeError):
    MEAN = "mean"
    MEDIAN = "median"
    MOST_FREQUENT = "most_frequent"

    STRATEGY = StringParam(
        "strategy", "The imputation strategy.", MEAN,
        ParamValidators.in_array(MEAN, MEDIAN, MOST_FREQUENT))


class ImputerModel(Model, ImputerModelParams):
    """Replaces missing values with per-column surrogates
    (ref: feature/imputer/ImputerModel.java)."""

    def __init__(self, surrogates: Optional[List[float]] = None, **kwargs):
        super().__init__(**kwargs)
        self.surrogates = (None if surrogates is None
                           else [float(s) for s in surrogates])

    def transform(self, table: Table) -> Tuple[Table]:
        if self.surrogates is None:
            raise ValueError("ImputerModel has no model data")
        outs = {}
        for name, out_name, surrogate in zip(
                self.input_cols, self.output_cols, self.surrogates):
            col = table.column(name)
            if isinstance(col, torch.Tensor):
                # on the column's device, in its dtype
                outs[out_name] = torch.where(
                    _missing_mask(col, self.missing_value),
                    torch.as_tensor(surrogate, dtype=col.dtype,
                                    device=col.device), col)
                continue
            vals = np.asarray(col, np.float64).copy()
            vals[_missing_mask(vals, self.missing_value)] = surrogate
            outs[out_name] = vals
        return (table.with_columns(**outs),)

    def set_model_data(self, model_data: Table):
        self.surrogates = [float(v) for v in model_data.column("surrogates")]
        return self

    def get_model_data(self) -> Tuple[Table]:
        return (Table.from_columns(
            surrogates=np.asarray(self.surrogates, np.float64)),)

    def _save_extra(self, path: str) -> None:
        rw.save_model_json(path, "model", {"surrogates": self.surrogates})

    def _load_extra(self, path: str, meta: dict) -> None:
        self.surrogates = rw.load_model_json(path, "model")["surrogates"]


class Imputer(Estimator, ImputerParams):
    def fit(self, table: Table) -> ImputerModel:
        surrogates = []
        mv = self.missing_value
        for name in self.input_cols:
            col = table.column(name)
            if isinstance(col, torch.Tensor):
                surrogates.append(self._device_surrogate(name, col, mv))
                continue
            vals = np.asarray(col, np.float64)
            missing = _missing_mask(vals, mv)
            present = vals[~missing & ~np.isnan(vals)]
            if len(present) == 0:
                raise ValueError(f"column {name!r} has no non-missing values")
            if self.strategy == self.MEAN:
                surrogates.append(float(present.mean()))
            elif self.strategy == self.MEDIAN:
                # ε-approximate median (relativeError param; see ops.quantile)
                surrogates.append(float(np.quantile(present, 0.5,
                                                    method="lower")))
            else:  # most_frequent: smallest among ties (ref semantics)
                vals_u, counts = np.unique(present, return_counts=True)
                surrogates.append(float(vals_u[np.argmax(counts)]))
        model = ImputerModel(surrogates=surrogates, device=self._device)
        return self.copy_params_to(model)

    def _device_surrogate(self, name: str, col: torch.Tensor,
                          mv: float) -> float:
        """The host path's statistic over a tensor column, computed where
        it lives: the mean of the present values in float64; the median
        as ``np.quantile(method="lower")`` picks it, the value of rank
        floor((n - 1) / 2), by an exact ``kthvalue``; the most frequent
        value, the smallest among ties (``unique`` is sorted and
        ``argmax`` takes the first maximum)."""
        present = col[~_missing_mask(col, mv) & ~torch.isnan(col)]
        n = present.numel()
        if n == 0:
            raise ValueError(f"column {name!r} has no non-missing values")
        if self.strategy == self.MEAN:
            return float(present.to(torch.float64).mean())
        if self.strategy == self.MEDIAN:
            return float(torch.kthvalue(present, (n - 1) // 2 + 1).values)
        values, counts = torch.unique(present, return_counts=True)
        return float(values[torch.argmax(counts)])


# ---------------------------------------------------------------------------
# RandomSplitter
# ---------------------------------------------------------------------------

class RandomSplitter(AlgoOperator, HasSeed):
    """Randomly split one table into N by weight fractions
    (ref: feature/randomsplitter/RandomSplitter.java)."""

    WEIGHTS = FloatArrayParam(
        "weights", "The weights of the output tables.", (1.0, 1.0),
        ParamValidators.non_empty_array())

    def transform(self, table: Table) -> Tuple[Table, ...]:
        weights = np.asarray(self.weights, np.float64)
        if (weights <= 0).any():
            raise ValueError("weights must be positive")
        probs = np.cumsum(weights / weights.sum())
        rng = np.random.default_rng(self.get_seed_or_default())
        draws = rng.random(table.num_rows)
        bucket = np.searchsorted(probs, draws, side="right")
        bucket = np.minimum(bucket, len(weights) - 1)
        return tuple(table.take(np.nonzero(bucket == i)[0])
                     for i in range(len(weights)))


# ---------------------------------------------------------------------------
# SQLTransformer
# ---------------------------------------------------------------------------

class _SqlVectorEval:
    """Vectorized evaluator for the flat SELECT/WHERE subset of SQL.

    Tensor columns evaluate as torch operations on their device (the
    column's dtype, as numpy keeps a host column's); host columns as numpy
    operations.

    The reference executes Flink SQL — a vectorizing/codegen engine — so
    evaluating simple statements as whole-column numpy expressions is the
    faithful performance shape; the row-at-a-time sqlite path is kept for
    everything this grammar doesn't cover. Supported:
    ``SELECT item[, ...] FROM __THIS__ [WHERE cond]`` where items are
    ``*``, column refs, arithmetic (+ - * / %), unary minus, ABS/SQRT/
    EXP/LN/LOG/LOWER/UPPER/POWER, numeric/string literals, ``AS`` aliases;
    WHERE supports comparisons, AND/OR/NOT. No aggregates, GROUP BY,
    ORDER BY, LIMIT, JOIN, subqueries, DISTINCT — those fall back.
    NaN deviates from sqlite: it stays IEEE NaN here (false in every
    comparison), while sqlite stores NaN as NULL.
    """

    _TOKEN = __import__("re").compile(
        r"\s*(?:(?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?"
        r"|\d+(?:[eE][+-]?\d+)?)"
        r"|(?P<str>'(?:[^']|'')*')"
        r"|(?P<qid>\"[^\"]+\")"
        r"|(?P<id>[A-Za-z_][A-Za-z_0-9]*)"
        r"|(?P<op><>|<=|>=|==|!=|[(),*+\-/%<>=]))")

    #: (numpy function, torch function): a call takes the torch one when
    #: an argument is a tensor
    _FUNCS = {
        "ABS": (np.abs, torch.abs), "SQRT": (np.sqrt, torch.sqrt),
        "EXP": (np.exp, torch.exp), "LN": (np.log, torch.log),
        "LOG": (np.log, torch.log), "LOWER": None, "UPPER": None,
        "POWER": (np.power, torch.pow),
    }
    _UNSUPPORTED = {"GROUP", "ORDER", "LIMIT", "JOIN", "UNION", "DISTINCT",
                    "HAVING", "CASE", "SELECT2"}

    def __init__(self, statement: str, table: Table, host_cols: dict):
        self.src = statement
        self.table = table
        self.visible = host_cols
        self.toks = []   # (kind, value, start, end)
        self.pos = 0

    class Unsupported(Exception):
        pass

    def _tokenize(self):
        i, src = 0, self.src
        while i < len(src):
            m = self._TOKEN.match(src, i)
            if m is None:
                if src[i:].strip() == "":
                    break
                raise self.Unsupported(f"cannot tokenize at {src[i:i+10]!r}")
            kind = m.lastgroup
            self.toks.append((kind, m.group(kind), m.start(kind), m.end()))
            i = m.end()

    def _peek(self):
        return self.toks[self.pos] if self.pos < len(self.toks) else \
            ("eof", "", len(self.src), len(self.src))

    def _next(self):
        t = self._peek()
        self.pos += 1
        return t

    def _expect(self, value):
        t = self._next()
        if t[1].upper() != value:
            raise self.Unsupported(f"expected {value}, got {t[1]!r}")

    def _kw(self, t):
        return t[0] == "id" and t[1].upper()

    def run(self):
        """Returns the output Table, or raises Unsupported → fallback."""
        self._tokenize()
        self._expect("SELECT")
        items = []  # (values, name) or ("*",)
        while True:
            t = self._peek()
            if t[1] == "*" and t[0] == "op":
                self._next()
                items.append(("star", None, None))
            else:
                start = t[2]
                vals = self._or()
                end_tok = self._peek()
                name = None
                if self._kw(end_tok) == "AS":
                    self._next()
                    nt = self._next()
                    if nt[0] not in ("id", "qid"):
                        raise self.Unsupported("expected alias after AS")
                    name = nt[1].strip('"')
                if name is None:
                    # sqlite names an un-aliased item by its literal text;
                    # a bare column ref keeps the column name
                    text = self.src[start:end_tok[2]].strip()
                    name = text.strip('"')
                items.append(("expr", vals, name))
            if self._peek()[1] == ",":
                self._next()
                continue
            break
        self._expect("FROM")
        ft = self._next()
        if ft[1] != "__THIS__":
            raise self.Unsupported("FROM must reference __THIS__")
        mask = None
        t = self._peek()
        if self._kw(t) == "WHERE":
            self._next()
            mask = self._or()
            if not isinstance(mask, torch.Tensor):
                mask = np.asarray(mask, bool)
                if mask.ndim == 0:  # constant predicate
                    mask = np.full(self.table.num_rows, bool(mask))
        if self._peek()[0] != "eof":
            raise self.Unsupported(f"trailing {self._peek()[1]!r}")

        cols = {}
        n = self.table.num_rows
        for kind, vals, name in items:
            if kind == "star":
                for cname, cvals in self.visible.items():
                    cols[cname] = cvals
                continue
            if np.ndim(vals) == 0:  # literal-only expression
                vals = np.full(n, vals)
            cols[name] = vals
        if mask is not None:
            cols = {k: _take_where(v, mask) for k, v in cols.items()}
        return Table.from_columns(**cols)

    # -- expression grammar (numpy-evaluated) -------------------------------
    def _or(self):
        v = self._and()
        while self._kw(self._peek()) == "OR":
            self._next()
            v = _logical(np.logical_or, torch.logical_or, v, self._and())
        return v

    def _and(self):
        v = self._not()
        while self._kw(self._peek()) == "AND":
            self._next()
            v = _logical(np.logical_and, torch.logical_and, v, self._not())
        return v

    def _not(self):
        if self._kw(self._peek()) == "NOT":
            self._next()
            v = self._not()
            return (torch.logical_not(v) if isinstance(v, torch.Tensor)
                    else np.logical_not(v))
        return self._cmp()

    def _cmp(self):
        v = self._add()
        op = self._peek()[1]
        if self._peek()[0] == "op" and op in ("=", "==", "!=", "<>", "<",
                                              "<=", ">", ">="):
            self._next()
            w = self._add()
            if op in ("=", "=="):
                return v == w
            if op in ("!=", "<>"):
                return v != w
            return {"<": operator.lt, "<=": operator.le, ">": operator.gt,
                    ">=": operator.ge}[op](v, w)
        return v

    def _add(self):
        v = self._mul()
        while self._peek()[0] == "op" and self._peek()[1] in "+-":
            op = self._next()[1]
            w = self._mul()
            v = v + w if op == "+" else v - w
        return v

    @staticmethod
    def _both_int(v, w):
        return _is_int(v) and _is_int(w)

    def _mul(self):
        v = self._unary()
        while self._peek()[0] == "op" and self._peek()[1] in "*/%":
            op = self._next()[1]
            w = self._unary()
            if op == "*":
                v = v * w
            elif self._both_int(v, w) and bool(_any(w == 0)):
                # sqlite yields NULL on integer div/mod by zero; numpy
                # floor_divide yields 0 — route to the sqlite fallback
                # rather than silently diverge
                raise self.Unsupported("integer division by zero")
            elif self._both_int(v, w):
                # sqlite integer semantics: division and remainder
                # truncate toward zero (numpy's floor/floor-sign differ
                # for mixed signs)
                q = v // w
                r = v - q * w
                q = q + ((r != 0) & (_lt0(v) != _lt0(w)))
                v = q if op == "/" else v - q * w
            elif op == "/":
                v = v / w
            else:
                v = (torch.remainder(v, w) if _has_tensor(v, w)
                     else np.mod(v, w))
        return v

    def _unary(self):
        if self._peek()[0] == "op" and self._peek()[1] == "-":
            self._next()
            return -self._unary()
        return self._primary()

    def _primary(self):
        t = self._next()
        if t[0] == "num":
            text = t[1]
            return float(text) if any(c in text for c in ".eE") \
                else int(text)
        if t[0] == "str":
            return t[1][1:-1].replace("''", "'")
        if t[0] == "op" and t[1] == "(":
            v = self._or()
            self._expect(")")
            return v
        if t[0] == "qid":
            return self._column(t[1].strip('"'))
        if t[0] == "id":
            name = t[1]
            if self._peek()[1] == "(" and self._peek()[0] == "op":
                fn = name.upper()
                if fn not in self._FUNCS:
                    raise self.Unsupported(f"function {name}")
                self._next()
                args = [self._or()]
                while self._peek()[1] == ",":
                    self._next()
                    args.append(self._or())
                self._expect(")")
                if fn in ("LOWER", "UPPER"):
                    if len(args) != 1:
                        raise self.Unsupported(f"{fn} arity")
                    a = args[0]
                    a = a.cpu().numpy() if isinstance(a, torch.Tensor) \
                        else np.asarray(a)
                    return (np.char.lower if fn == "LOWER"
                            else np.char.upper)(a.astype(str))
                np_f, torch_f = self._FUNCS[fn]
                want = 2 if fn == "POWER" else 1
                if len(args) != want:
                    raise self.Unsupported(f"{fn} arity")
                if _has_tensor(*args):
                    return torch_f(*args)
                return np_f(*args)
            if name.upper() in self._UNSUPPORTED or name.upper() in (
                    "WHERE", "FROM", "AS", "AND", "OR", "NOT", "SELECT"):
                raise self.Unsupported(f"keyword {name} in expression")
            return self._column(name)
        raise self.Unsupported(f"unexpected token {t[1]!r}")

    def _column(self, name: str):
        if name in self.visible:
            return self.visible[name]
        for k in self.visible:  # SQL identifiers are case-insensitive
            if k.lower() == name.lower():
                return self.visible[k]
        raise self.Unsupported(f"unknown column {name!r}")


def _has_tensor(*vals) -> bool:
    return any(isinstance(v, torch.Tensor) for v in vals)


def _is_int(v) -> bool:
    if isinstance(v, torch.Tensor):
        return not v.is_floating_point() and v.dtype != torch.bool
    return np.asarray(v).dtype.kind in "iu"


def _any(v) -> bool:
    return bool(v.any()) if isinstance(v, torch.Tensor) else bool(np.any(v))


def _lt0(v):
    return v < 0 if isinstance(v, torch.Tensor) else np.asarray(v) < 0


def _logical(np_f, torch_f, v, w):
    if _has_tensor(v, w):
        dev = (v if isinstance(v, torch.Tensor) else w).device
        return torch_f(torch.as_tensor(v, device=dev),
                       torch.as_tensor(w, device=dev))
    return np_f(v, w)


def _take_where(v, mask):
    """The rows of column ``v`` where ``mask`` holds; a tensor column (or a
    tensor mask) selects on the tensor's device."""
    if isinstance(v, torch.Tensor):
        return v[torch.as_tensor(mask, device=v.device)]
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy()
    return v[np.nonzero(mask)[0]]


def _register_math_fallbacks(conn: sqlite3.Connection) -> None:
    """Register the SQL math functions this framework's statements use on
    sqlite builds compiled without SQLITE_ENABLE_MATH_FUNCTIONS (probe:
    ``SELECT SQRT(1)``). NULL in and domain errors out both yield NULL —
    the built-ins' behavior (``SQRT(-1)`` is NULL, not an error)."""
    import math

    try:
        conn.execute("SELECT SQRT(1)")
        return
    except sqlite3.OperationalError:
        pass

    def unary(f):
        def call(x):
            if x is None:
                return None
            try:
                return f(float(x))
            except (ValueError, OverflowError):
                return None
        return call

    def binary(f):
        def call(x, y):
            if x is None or y is None:
                return None
            try:
                return f(float(x), float(y))
            except (ValueError, OverflowError):
                return None
        return call

    for name, fn in (("SQRT", unary(math.sqrt)), ("EXP", unary(math.exp)),
                     ("LN", unary(math.log)), ("LOG10", unary(math.log10)),
                     ("FLOOR", unary(math.floor)),
                     ("CEIL", unary(math.ceil)),
                     ("CEILING", unary(math.ceil)),
                     ("POW", binary(math.pow)),
                     ("POWER", binary(math.pow)),
                     ("MOD", binary(math.fmod))):
        conn.create_function(name, fn.__code__.co_argcount, fn,
                             deterministic=True)


class SQLTransformer(Transformer):
    """SQL SELECT over the input table, with ``__THIS__`` as the table name
    (ref: feature/sqltransformer/SQLTransformer.java — the reference runs
    Flink SQL). Flat SELECT/WHERE statements evaluate as vectorized
    whole-column expressions (_SqlVectorEval — the performance shape of the
    reference's vectorizing SQL engine); anything beyond that subset
    executes on an in-memory sqlite database over the table's scalar and
    string columns. Vector/array columns are NOT visible to SQL and are
    dropped from the output (SQL may reorder/filter rows, so they cannot
    be re-attached)."""

    STATEMENT = StringParam(
        "statement", "SQL statement with __THIS__ as the input table.", None,
        ParamValidators.not_null())

    def transform(self, table: Table) -> Tuple[Table]:
        statement = self.statement
        if "__THIS__" not in statement:
            raise ValueError("statement must reference __THIS__")

        def sql_visible(col):
            # decided on the RAW column: no host materialization just to
            # find out a 10M-row CSR/vector column is invisible anyway
            if isinstance(col, torch.Tensor):
                return col.ndim == 1
            if getattr(col, "is_csr_vector_column", False):
                return False
            if getattr(col, "ndim", None) != 1:
                return False
            if col.dtype != object:
                return True
            return len(col) == 0 or isinstance(col[0], str)

        names = [n for n in table.column_names
                 if sql_visible(table.column(n))]
        if not names:
            raise ValueError(
                "SQLTransformer needs at least one scalar or string "
                "column; vector columns are not visible to SQL. "
                f"Input columns: {table.column_names}")
        # the vectorized evaluator sees tensor columns as they are
        visible = {n: table.column(n) if isinstance(table.column(n),
                                                    torch.Tensor)
                   else table._host_column(n) for n in names}
        try:
            return (_SqlVectorEval(statement, table, visible).run(),)
        except _SqlVectorEval.Unsupported:
            pass
        except (TypeError, ValueError, IndexError, AttributeError,
                RuntimeError):
            # grammar accepted it but vectorized evaluation failed on the
            # actual dtypes (e.g. ABS over strings) — sqlite decides
            pass
        host_cols = {n: table._host_column(n) for n in names}
        conn = sqlite3.connect(":memory:")
        try:
            _register_math_fallbacks(conn)
            col_defs = ", ".join(f'"{n}"' for n in host_cols)
            conn.execute(f"CREATE TABLE __input__ ({col_defs})")
            placeholders = ", ".join("?" * len(host_cols))
            # .tolist() converts whole columns to Python scalars C-side
            conn.executemany(
                f"INSERT INTO __input__ VALUES ({placeholders})",
                zip(*[c.tolist() for c in host_cols.values()]))
            cursor = conn.execute(
                statement.replace("__THIS__", "__input__"))
            if cursor.description is None:
                raise ValueError(
                    "statement must be a SELECT producing rows, got: "
                    + statement)
            names = [d[0] for d in cursor.description]
            data = cursor.fetchall()
        finally:
            conn.close()
        cols = {name: np.asarray([row[i] for row in data])
                for i, name in enumerate(names)}
        return (Table.from_columns(**cols),)


# ---------------------------------------------------------------------------
# MinHashLSH
# ---------------------------------------------------------------------------

_MERSENNE_PRIME = (1 << 61) - 1


class LSHParams(HasInputCol, HasOutputCol):
    NUM_HASH_TABLES = IntParam(
        "numHashTables", "Number of hash tables.", 1, ParamValidators.gt_eq(1))
    NUM_HASH_FUNCTIONS_PER_TABLE = IntParam(
        "numHashFunctionsPerTable",
        "Number of hash functions per hash table (AND-amplification).", 1,
        ParamValidators.gt_eq(1))


class MinHashLSHModel(Model, LSHParams, HasSeed):
    """MinHash over the non-zero index set of a vector
    (ref: feature/lsh/MinHashLSHModel.java + LSHModel.java extra APIs
    approxNearestNeighbors:141 / approxSimilarityJoin:210, distance =
    Jaccard)."""

    def __init__(self, coeff_a=None, coeff_b=None, **kwargs):
        super().__init__(**kwargs)
        self.coeff_a = None if coeff_a is None else np.asarray(coeff_a, np.int64)
        self.coeff_b = None if coeff_b is None else np.asarray(coeff_b, np.int64)

    # -- hashing -------------------------------------------------------------
    def _nonzero_indices(self, v) -> np.ndarray:
        if isinstance(v, SparseVector):
            return v.indices
        if isinstance(v, Vector):
            return np.nonzero(v.to_array())[0]
        return np.nonzero(np.asarray(v))[0]

    def _hash_one(self, v) -> np.ndarray:
        idx = self._nonzero_indices(v)
        if len(idx) == 0:
            raise ValueError("MinHash needs at least one non-zero entry")
        # (a·(i+1) + b) mod p, min over the index set — per hash function
        vals = (self.coeff_a[:, None] * (idx[None, :] + 1)
                + self.coeff_b[:, None]) % _MERSENNE_PRIME
        mins = vals.min(axis=1).astype(np.float64)
        return mins.reshape(self.num_hash_tables,
                            self.num_hash_functions_per_table)

    def _hash_column(self, col) -> np.ndarray:
        """All rows' MinHash signatures at once: (n, tables, fns).

        The whole column goes through one CSR (sparse columns zero-copy,
        dense ones via their nonzero pattern) and each hash function's
        per-row min is a ``minimum.reduceat`` over the stored indices —
        no per-row Python. Chunked so the (H, nnz) hash matrix stays
        bounded regardless of column size.
        """
        import scipy.sparse as sp

        from flink_ml_tpu_torch.linalg import sparse as sp_mod

        h = len(self.coeff_a)
        if sp_mod.is_csr_column(col) or (
                sp_mod.is_sparse_column(col)
                and all(isinstance(v, SparseVector) for v in col)):
            # hash over STORED indices, like _hash_one on SparseVector
            # (explicit zeros participate — reference semantics)
            m = sp_mod.column_to_csr(col)
        elif getattr(col, "dtype", None) == object:
            # mixed sparse/dense rows: dense rows hash their NONZERO
            # pattern while sparse rows hash stored indices — per-row
            # dispatch is the only faithful evaluation
            out = np.empty((len(col), self.num_hash_tables,
                            self.num_hash_functions_per_table), np.float64)
            for i in range(len(col)):
                out[i] = self._hash_one(col[i])
            return out
        else:
            if isinstance(col, torch.Tensor):
                col = col.cpu().numpy()
            dense = np.asarray(col, np.float64)
            if dense.ndim == 1:
                dense = dense[:, None]
            m = sp.csr_matrix(dense)  # stores only nonzeros, as _hash_one
        if (np.diff(m.indptr) == 0).any():
            raise ValueError("MinHash needs at least one non-zero entry")
        n = m.shape[0]
        out = np.empty((n, h), np.float64)
        nnz_budget = max(1, 50_000_000 // max(int(h), 1))
        r0 = 0
        while r0 < n:
            # chunk by nnz so the (h, chunk_nnz) hash matrix stays bounded
            r1 = int(np.searchsorted(m.indptr, m.indptr[r0] + nnz_budget,
                                     side="left"))
            r1 = min(max(r1, r0 + 1), n)
            lo, hi = m.indptr[r0], m.indptr[r1]
            idx = m.indices[lo:hi].astype(np.int64)
            vals = (self.coeff_a[:, None] * (idx[None, :] + 1)
                    + self.coeff_b[:, None]) % _MERSENNE_PRIME
            local_ptr = (m.indptr[r0:r1] - lo).astype(np.int64)
            out[r0:r1] = np.minimum.reduceat(vals, local_ptr, axis=1).T
            r0 = r1
        return out.reshape(n, self.num_hash_tables,
                           self.num_hash_functions_per_table)

    def transform(self, table: Table) -> Tuple[Table]:
        if self.coeff_a is None:
            raise ValueError("MinHashLSHModel has no model data")
        col = table.column(self.input_col)
        hashes = self._hash_column(col)
        out = np.empty(len(col), dtype=object)
        for i in range(len(col)):
            out[i] = [DenseVector(h) for h in hashes[i]]
        return (table.with_column(self.output_col, out),)

    # -- extra model APIs (ref: LSHModel.java:141,210) ----------------------
    @staticmethod
    def _jaccard_distance(a, b) -> float:
        sa, sb = set(a.tolist()), set(b.tolist())
        union = len(sa | sb)
        return 1.0 - (len(sa & sb) / union if union else 0.0)

    def approx_nearest_neighbors(self, dataset: Table, key, k: int,
                                 dist_col: str = "distCol") -> Table:
        """k nearest rows to ``key`` by Jaccard distance, pre-filtered to
        rows sharing at least one hash-table bucket with the key."""
        key_hashes = self._hash_one(key)
        key_idx = self._nonzero_indices(key)
        col = dataset.column(self.input_col)
        hashes = self._hash_column(col)  # (n, T, F), one vectorized pass
        match = (hashes == key_hashes[None, :, :]).all(axis=2).any(axis=1)
        candidates = np.nonzero(match)[0]
        dists = [(i, self._jaccard_distance(
            self._nonzero_indices(col[i]), key_idx)) for i in candidates]
        dists.sort(key=lambda t: t[1])
        top = dists[:k]
        idx = np.asarray([i for i, _ in top], np.int64)
        out = dataset.take(idx)
        return out.with_column(dist_col,
                               np.asarray([d for _, d in top], np.float64))

    def approx_similarity_join(self, table_a: Table, table_b: Table,
                               threshold: float, id_col: str,
                               dist_col: str = "distCol") -> Table:
        """Join pairs with Jaccard distance ≤ threshold, bucketed by hash
        equality on any table (ref: LSHModel.approxSimilarityJoin:210)."""
        def buckets(table):
            col = table.column(self.input_col)
            hashes = self._hash_column(col)  # per-row hashing vectorized
            out = {}
            for i in range(len(col)):
                for t in range(self.num_hash_tables):
                    out.setdefault((t,) + tuple(hashes[i, t]), []).append(i)
            return out

        buckets_a, buckets_b = buckets(table_a), buckets(table_b)
        pairs = set()
        for bucket, rows_a in buckets_a.items():
            for i in rows_a:
                for j in buckets_b.get(bucket, ()):
                    pairs.add((i, j))
        ids_a, ids_b, dists = [], [], []
        col_a, col_b = table_a.column(self.input_col), \
            table_b.column(self.input_col)
        for i, j in sorted(pairs):
            d = self._jaccard_distance(self._nonzero_indices(col_a[i]),
                                       self._nonzero_indices(col_b[j]))
            if d <= threshold:
                ids_a.append(table_a.column(id_col)[i])
                ids_b.append(table_b.column(id_col)[j])
                dists.append(d)
        return Table.from_columns(**{
            f"{id_col}A": np.asarray(ids_a),
            f"{id_col}B": np.asarray(ids_b),
            dist_col: np.asarray(dists, np.float64)})

    # -- model data ----------------------------------------------------------
    def set_model_data(self, model_data: Table):
        self.coeff_a = np.asarray(
            [int(v) for v in model_data.column("coeffA")], np.int64)
        self.coeff_b = np.asarray(
            [int(v) for v in model_data.column("coeffB")], np.int64)
        return self

    def get_model_data(self) -> Tuple[Table]:
        return (Table.from_columns(
            coeffA=self.coeff_a.astype(np.float64),
            coeffB=self.coeff_b.astype(np.float64)),)

    def _save_extra(self, path: str) -> None:
        rw.save_model_arrays(path, "model", {
            "coeffA": self.coeff_a, "coeffB": self.coeff_b})

    def _load_extra(self, path: str, meta: dict) -> None:
        arrays = rw.load_model_arrays(path, "model")
        self.coeff_a, self.coeff_b = arrays["coeffA"], arrays["coeffB"]


class MinHashLSH(Estimator, LSHParams, HasSeed):
    def fit(self, table: Table) -> MinHashLSHModel:
        rng = np.random.default_rng(self.get_seed_or_default())
        n = self.num_hash_tables * self.num_hash_functions_per_table
        # coefficients < 2^31 keep a·(i+1) within int64 for any realistic dim
        model = MinHashLSHModel(
            coeff_a=rng.integers(1, 1 << 31, n, dtype=np.int64),
            coeff_b=rng.integers(0, 1 << 31, n, dtype=np.int64),
            device=self._device)
        return self.copy_params_to(model)
