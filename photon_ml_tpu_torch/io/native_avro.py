"""Plan-driven native Avro column decoder (ctypes binding; port of
``photon_ml_tpu/io/native_avro.py``). It loads the same C++ source,
``native/avro_reader.cpp``, and builds it with g++ into the port's build
directory (``utils.device.build_dir``).

Reference role: avro/AvroUtils.scala:54+ and avro/data/
DataProcessingUtils.scala:57-143 decode Avro GenericRecords on the JVM
inside Spark executors; the pure-Python fallback here is
photon_ml_tpu_torch.io.avro_codec. This binding compiles the record schema
into a compact uint32 "plan" (see native/avro_reader.cpp for the
bytecode) and lets the C++ interpreter materialize ONLY the requested
columns: numeric scalars as float64, string scalars / metadataMap
lookups as interned int32 ids, and feature bags as
(row_ptr, key_ids, values) with a per-file string table.

Use :func:`decode_columns` directly, or the higher-level helpers in the
input formats which fall back to the Python codec when the native build
or the schema shape is unsupported.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.io.avro_codec import read_container
from photon_ml_tpu_torch.utils.device import build_dir

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_SRC = os.path.join(_REPO_ROOT, "native", "avro_reader.cpp")
_COMPILE_LOCK = threading.Lock()
_lib_handle = None

# bytecode opcodes — keep in sync with native/avro_reader.cpp
_OPS = {
    "null": 0, "boolean": 1, "int": 2, "long": 3, "float": 4,
    "double": 5, "bytes": 6, "string": 7,
}
_OP_UNION, _OP_RECORD, _OP_ARRAY, _OP_MAP = 8, 9, 10, 11
_CAP_NUM, _CAP_STR, _CAP_BAG, _CAP_MAP = 16, 17, 18, 19
_NUMERIC = {"boolean", "int", "long", "float", "double"}


class PlanError(ValueError):
    """Schema shape the native decoder cannot handle; callers fall back."""


def _lib():
    global _lib_handle
    if _lib_handle is not None:
        return _lib_handle
    with _COMPILE_LOCK:
        if _lib_handle is not None:
            return _lib_handle
        lib_dir = build_dir()
        lib_path = os.path.join(lib_dir, "libavro_reader.so")
        if not (
            os.path.isfile(lib_path)
            and os.path.getmtime(lib_path) >= os.path.getmtime(_SRC)
        ):
            os.makedirs(lib_dir, exist_ok=True)
            # temp path + atomic rename: another process never loads a
            # half-written library
            tmp_path = f"{lib_path}.{os.getpid()}.tmp"
            subprocess.run(
                [
                    "g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                    _SRC, "-o", tmp_path, "-lz",
                ],
                check=True,
                capture_output=True,
            )
            os.replace(tmp_path, lib_path)
        lib = ctypes.CDLL(lib_path)
        lib.pavro_decode.restype = ctypes.c_void_p
        lib.pavro_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_uint32,
        ]
        lib.pavro_last_error.restype = ctypes.c_char_p
        lib.pavro_nrecords.restype = ctypes.c_int64
        lib.pavro_nrecords.argtypes = [ctypes.c_void_p]
        lib.pavro_col_f64.restype = ctypes.c_int64
        lib.pavro_col_f64.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ]
        lib.pavro_col_i32.restype = ctypes.c_int64
        lib.pavro_col_i32.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ]
        lib.pavro_bag.restype = ctypes.c_int64
        lib.pavro_bag.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.pavro_strings.restype = ctypes.c_int64
        lib.pavro_strings.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64)),
        ]
        lib.pavro_free.argtypes = [ctypes.c_void_p]
        _lib_handle = lib
        return lib


def available() -> bool:
    """Whether the decoder builds and loads (g++ and zlib present)."""
    try:
        _lib()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


# ---------------------------------------------------------------------------
# plan compilation
# ---------------------------------------------------------------------------


def _type_name(schema) -> Optional[str]:
    if isinstance(schema, str):
        return schema
    if isinstance(schema, dict):
        return schema.get("type")
    return None


def _emit_plain(schema, out: List[int]) -> None:
    """Emit ops that DECODE (skip) a value of this schema."""
    t = _type_name(schema)
    if isinstance(schema, list):
        out.append(_OP_UNION)
        out.append(len(schema))
        for branch in schema:
            sub: List[int] = []
            _emit_plain(branch, sub)
            out.append(len(sub))
            out.extend(sub)
        return
    if t in _OPS:
        out.append(_OPS[t])
        return
    if t == "record":
        fields = schema["fields"]
        out.append(_OP_RECORD)
        out.append(len(fields))
        for f in fields:
            _emit_plain(f["type"], out)
        return
    if t == "array":
        sub = []
        _emit_plain(schema["items"], sub)
        out.append(_OP_ARRAY)
        out.append(len(sub))
        out.extend(sub)
        return
    if t == "map":
        sub = []
        _emit_plain(schema["values"], sub)
        out.append(_OP_MAP)
        out.append(len(sub))
        out.extend(sub)
        return
    if t == "enum":
        out.append(_OPS["long"])  # enums encode as int
        return
    if t == "fixed":
        raise PlanError("fixed not supported by native decoder")
    raise PlanError(f"unsupported schema node: {schema!r}")


# Every scalar type is capturable under a string sink: numeric/bool
# branches render as their Python-str form (C++ Sink::render_double /
# %lld / True|False) — the metronome TrainingExample schema types uid as
# [null, string, long, int] and GAME id columns are frequently plain ints.
_STR_CAPTURABLE = {"string", "bytes"} | _NUMERIC


def _is_stringish(schema) -> bool:
    t = _type_name(schema)
    if t in _STR_CAPTURABLE:
        return True
    if isinstance(schema, list):
        return all(
            _type_name(b) == "null" or _type_name(b) in _STR_CAPTURABLE
            for b in schema
        )
    return False


def _is_numeric(schema) -> bool:
    """Capturable under a numeric sink. Union branches beyond the numeric
    ones are tolerated when a numeric branch exists: a string branch
    parses via strtod when it holds a number and reads as NaN-missing
    otherwise (the metronome label union is
    [double,float,int,long,boolean,string])."""
    t = _type_name(schema)
    if t in _NUMERIC:
        return True
    if isinstance(schema, list):
        names = [_type_name(b) for b in schema]
        if not any(n in _NUMERIC for n in names):
            return False
        return all(
            n in _NUMERIC or n in ("null", "string", "bytes") for n in names
        )
    return False


def _bag_item_record(schema):
    """array-of-record (possibly behind [null, array]) -> record schema."""
    if isinstance(schema, list):
        non_null = [b for b in schema if _type_name(b) != "null"]
        if len(non_null) != 1:
            raise PlanError("bag union must be [null, array]")
        schema = non_null[0]
    if _type_name(schema) != "array":
        raise PlanError("bag field is not an array")
    item = schema["items"]
    if _type_name(item) != "record":
        raise PlanError("bag items are not records")
    return schema, item


class Plan:
    """Compiled column plan for one record schema."""

    def __init__(self, schema):
        if _type_name(schema) != "record":
            raise PlanError("top-level schema must be a record")
        self.schema = schema
        self.ops: List[int] = []
        self.num_slots: Dict[str, int] = {}
        self.str_slots: Dict[str, int] = {}
        self.bag_slots: Dict[str, int] = {}
        self.map_keys: List[str] = []
        self._n_num = 0
        self._n_str = 0
        self._n_bag = 0

    def compile(
        self,
        numeric_fields: Sequence[str] = (),
        string_fields: Sequence[str] = (),
        bag_fields: Sequence[str] = (),
        map_field: Optional[str] = None,
        map_keys: Sequence[str] = (),
    ) -> "Plan":
        fields = self.schema["fields"]
        by_name = {f["name"]: f for f in fields}
        for name in list(numeric_fields) + list(string_fields) + list(bag_fields):
            if name not in by_name:
                raise PlanError(f"field {name!r} not in schema")
        if map_field is not None and map_field not in by_name:
            raise PlanError(f"map field {map_field!r} not in schema")
        self.map_keys = list(map_keys)

        out = self.ops
        out.append(_OP_RECORD)
        out.append(len(fields))
        for f in fields:
            name, ftype = f["name"], f["type"]
            if name in numeric_fields:
                if not _is_numeric(ftype):
                    raise PlanError(f"{name!r} is not numeric")
                slot = self._n_num
                self._n_num += 1
                self.num_slots[name] = slot
                out.extend([_CAP_NUM, slot])
                _emit_plain(ftype, out)
            elif name in string_fields:
                if not _is_stringish(ftype):
                    raise PlanError(f"{name!r} is not a string")
                slot = self._n_str
                self._n_str += 1
                self.str_slots[name] = slot
                out.extend([_CAP_STR, slot])
                _emit_plain(ftype, out)
            elif name in bag_fields:
                arr, item = _bag_item_record(ftype)
                if isinstance(ftype, list):
                    # [null, array]: decode the union head, capture inside
                    non_null_idx = next(
                        i for i, b in enumerate(ftype)
                        if _type_name(b) != "null"
                    )
                    out.append(_OP_UNION)
                    out.append(len(ftype))
                    for i, branch in enumerate(ftype):
                        sub: List[int] = []
                        if i == non_null_idx:
                            self._emit_bag(name, item, sub)
                        else:
                            _emit_plain(branch, sub)
                        out.append(len(sub))
                        out.extend(sub)
                else:
                    self._emit_bag(name, item, out)
            elif name == map_field:
                t = _type_name(ftype)
                inner = ftype
                if isinstance(ftype, list):
                    non_null = [
                        b for b in ftype if _type_name(b) != "null"
                    ]
                    if len(non_null) != 1 or _type_name(non_null[0]) != "map":
                        raise PlanError("map union must be [null, map]")
                    out.append(_OP_UNION)
                    out.append(len(ftype))
                    for branch in ftype:
                        sub = []
                        inner_pos = None
                        if _type_name(branch) == "map":
                            self._emit_map(branch, sub)
                            inner_pos = self._map_out_pos
                        else:
                            _emit_plain(branch, sub)
                        out.append(len(sub))
                        out.extend(sub)
                        if inner_pos is not None:
                            # _emit_map recorded the slot-operand position
                            # relative to `sub`; rebase onto the full stream
                            self._map_out_pos = len(out) - len(sub) + inner_pos
                    continue
                if t != "map":
                    raise PlanError(f"{map_field!r} is not a map")
                self._emit_map(inner, out)
            else:
                _emit_plain(ftype, out)
        return self

    def _emit_bag(self, name: str, item, out: List[int]) -> None:
        slot = self._n_bag
        self._n_bag += 1
        self.bag_slots[name] = slot
        ifields = item["fields"]
        roles = {}
        for i, f in enumerate(ifields):
            if f["name"] == "name":
                roles[i] = 1
            elif f["name"] == "term":
                roles[i] = 2
            elif f["name"] == "value":
                roles[i] = 3
        if 1 not in roles.values() or 3 not in roles.values():
            raise PlanError(f"bag {name!r} items lack name/value fields")
        if 2 in roles.values():
            name_i = next(i for i, r in roles.items() if r == 1)
            term_i = next(i for i, r in roles.items() if r == 2)
            if term_i < name_i:
                raise PlanError("term field precedes name field")
        out.extend([_CAP_BAG, slot, len(ifields)])
        for i, f in enumerate(ifields):
            role = roles.get(i, 0)
            if role in (1, 2) and not _is_stringish(f["type"]):
                raise PlanError("bag name/term must be strings")
            if role == 3 and not _is_numeric(f["type"]):
                raise PlanError("bag value must be numeric")
            sub: List[int] = []
            _emit_plain(f["type"], sub)
            out.append(role)
            out.append(len(sub))
            out.extend(sub)

    def _emit_map(self, schema, out: List[int]) -> None:
        if not _is_stringish(schema["values"]):
            raise PlanError("metadata map values must be scalar")
        sub: List[int] = []
        _emit_plain(schema["values"], sub)
        # map ids land in i32 slots AFTER the named string slots; the
        # final slot base is fixed in finalize()
        self._map_out_pos = len(out) + 1  # position of slot_base operand
        out.extend([_CAP_MAP, 0, len(sub)])
        out.extend(sub)

    def finalize(self) -> np.ndarray:
        if self.map_keys and hasattr(self, "_map_out_pos"):
            self.ops[self._map_out_pos] = self._n_str
        return np.asarray(self.ops, dtype=np.uint32)

    def map_slot(self, key: str) -> int:
        return self._n_str + self.map_keys.index(key)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


class DecodedColumns:
    """One file's requested columns + the interned string table."""

    def __init__(self, handle, lib, plan: Plan):
        self._h = handle
        self._lib = lib
        self.plan = plan
        self.num_records = int(lib.pavro_nrecords(handle))
        blob_p = ctypes.c_char_p()
        off_p = ctypes.POINTER(ctypes.c_uint64)()
        n = lib.pavro_strings(handle, ctypes.byref(blob_p), ctypes.byref(off_p))
        offs = np.ctypeslib.as_array(off_p, shape=(n + 1,)).copy() if n else np.zeros(1, np.uint64)
        blob = ctypes.string_at(blob_p, int(offs[-1])) if n else b""
        text = blob.decode("utf-8")
        o = offs.tolist()
        if len(text) == len(blob):
            # ASCII: byte offsets are character offsets, so the strings
            # are slices of one decoded text
            self.strings: List[str] = list(map(text.__getitem__, map(slice, o[:-1], o[1:])))
        else:
            self.strings = [blob[o[i]:o[i + 1]].decode("utf-8") for i in range(n)]

    def f64(self, field: str) -> np.ndarray:
        slot = self.plan.num_slots[field]
        p = ctypes.POINTER(ctypes.c_double)()
        n = self._lib.pavro_col_f64(self._h, slot, ctypes.byref(p))
        return np.ctypeslib.as_array(p, shape=(n,)).copy() if n > 0 else np.zeros(0)

    def str_ids(self, field: str) -> np.ndarray:
        slot = self.plan.str_slots[field]
        return self._i32(slot)

    def map_ids(self, key: str) -> np.ndarray:
        return self._i32(self.plan.map_slot(key))

    def _i32(self, slot: int) -> np.ndarray:
        p = ctypes.POINTER(ctypes.c_int32)()
        n = self._lib.pavro_col_i32(self._h, slot, ctypes.byref(p))
        return (
            np.ctypeslib.as_array(p, shape=(n,)).copy()
            if n > 0
            else np.zeros(0, np.int32)
        )

    def bag(self, field: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (row_ptr [n+1], key_ids [nnz], values [nnz])."""
        slot = self.plan.bag_slots[field]
        rp = ctypes.POINTER(ctypes.c_int64)()
        ki = ctypes.POINTER(ctypes.c_int32)()
        vs = ctypes.POINTER(ctypes.c_double)()
        nnz = ctypes.c_int64()
        n = self._lib.pavro_bag(
            self._h, slot, ctypes.byref(rp), ctypes.byref(ki),
            ctypes.byref(vs), ctypes.byref(nnz),
        )
        row_ptr = (
            np.ctypeslib.as_array(rp, shape=(n,)).copy()
            if n > 0
            else np.zeros(1, np.int64)
        )
        k = int(nnz.value)
        key_ids = (
            np.ctypeslib.as_array(ki, shape=(k,)).copy()
            if k
            else np.zeros(0, np.int32)
        )
        values = (
            np.ctypeslib.as_array(vs, shape=(k,)).copy()
            if k
            else np.zeros(0)
        )
        return row_ptr, key_ids, values

    def close(self) -> None:
        if self._h:
            self._lib.pavro_free(self._h)
            self._h = None

    def __del__(self):
        self.close()


def decode_columns(path: str, plan: Plan) -> DecodedColumns:
    """Decode one container file according to a compiled plan."""
    lib = _lib()
    with open(path, "rb") as f:
        data = f.read()
    ops = plan.finalize()
    keys = (ctypes.c_char_p * len(plan.map_keys))(
        *[k.encode("utf-8") for k in plan.map_keys]
    )
    h = lib.pavro_decode(
        data,
        len(data),
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(ops),
        keys,
        len(plan.map_keys),
    )
    if not h:
        raise ValueError(
            f"{path}: {lib.pavro_last_error().decode('utf-8', 'replace')}"
        )
    return DecodedColumns(h, lib, plan)


def plan_for_file(
    path: str,
    *,
    numeric_fields: Sequence[str] = (),
    string_fields: Sequence[str] = (),
    bag_fields: Sequence[str] = (),
    map_field: Optional[str] = None,
    map_keys: Sequence[str] = (),
) -> Plan:
    """Read a file's schema (header only via the Python codec) and compile
    a plan; raises PlanError when the shape is unsupported."""
    schema, _ = read_container(path)
    return Plan(schema).compile(
        numeric_fields=numeric_fields,
        string_fields=string_fields,
        bag_fields=bag_fields,
        map_field=map_field,
        map_keys=map_keys,
    )
