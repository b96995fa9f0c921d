"""Pure-Python Avro binary codec + object container files (port of
``photon_ml_tpu/io/avro_codec.py``; a container written here is
byte-identical to the JAX package's for the same records).

The runtime image ships no Avro library, so this is a from-scratch
implementation of the subset of the Avro 1.x spec the Photon ML data
contract needs (reference wire formats: photon-avro-schemas/src/main/avro/
*.avsc — records, unions with null, arrays, maps, enums, fixed, and all
primitives; container files with null/deflate codecs).

Reads are tolerant: any writer schema expressible in the supported subset
round-trips. Datum values map to plain Python types:
record -> dict, array -> list, map -> dict, union -> member value,
bytes/fixed -> bytes, null -> None.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import zlib
from typing import Any, BinaryIO, Dict, Iterable, Iterator, List, Optional, Tuple, Union

from photon_ml_tpu_torch.io.paths import expand_input_paths
from photon_ml_tpu_torch.reliability.artifacts import atomic_writer

MAGIC = b"Obj\x01"
SYNC_SIZE = 16
DEFAULT_SYNC_INTERVAL = 16 * 1024

_PRIMITIVES = {
    "null", "boolean", "int", "long", "float", "double", "bytes", "string"
}

SchemaType = Union[str, dict, list]


def parse_schema(
    schema: Union[str, SchemaType],
    named: Optional[Dict[str, dict]] = None,
) -> SchemaType:
    """Normalize a schema (JSON string or python structure), resolving named
    type references into a flat registry carried on the schema objects."""
    if isinstance(schema, str) and schema.lstrip().startswith(("{", "[", '"')):
        schema = json.loads(schema)
    named = named if named is not None else {}
    return _resolve(schema, named)


def _fullname(schema: dict) -> str:
    name = schema["name"]
    ns = schema.get("namespace")
    if ns and "." not in name:
        return f"{ns}.{name}"
    return name


def _resolve(schema: SchemaType, named: Dict[str, dict]) -> SchemaType:
    if isinstance(schema, str):
        if schema in _PRIMITIVES:
            return schema
        # named-type reference: try short and full name
        for key in (schema,):
            if key in named:
                return named[key]
        for full, s in named.items():
            if full.split(".")[-1] == schema:
                return s
        raise ValueError(f"unresolved schema reference: {schema}")
    if isinstance(schema, list):  # union
        return [_resolve(s, named) for s in schema]
    t = schema.get("type")
    if t in ("record", "error"):
        named[_fullname(schema)] = schema
        named[schema["name"]] = schema
        for f in schema["fields"]:
            f["type"] = _resolve(f["type"], named)
        return schema
    if t in ("enum", "fixed"):
        named[_fullname(schema)] = schema
        named[schema["name"]] = schema
        return schema
    if t == "array":
        schema["items"] = _resolve(schema["items"], named)
        return schema
    if t == "map":
        schema["values"] = _resolve(schema["values"], named)
        return schema
    if isinstance(t, (dict, list)):
        return _resolve(t, named)
    if t in _PRIMITIVES:
        return t
    raise ValueError(f"unsupported schema: {schema!r}")


# ---------------------------------------------------------------------------
# Binary encoding (Avro spec: zigzag varints, IEEE754 little-endian floats)
# ---------------------------------------------------------------------------


class BinaryEncoder:
    def __init__(self, out: BinaryIO):
        self.out = out

    def write_long(self, n: int) -> None:
        n = (n << 1) ^ (n >> 63)  # zigzag
        while (n & ~0x7F) != 0:
            self.out.write(bytes((n & 0x7F | 0x80,)))
            n >>= 7
        self.out.write(bytes((n,)))

    write_int = write_long

    def write_null(self, _=None) -> None:
        pass

    def write_boolean(self, b: bool) -> None:
        self.out.write(b"\x01" if b else b"\x00")

    def write_float(self, x: float) -> None:
        self.out.write(struct.pack("<f", x))

    def write_double(self, x: float) -> None:
        self.out.write(struct.pack("<d", x))

    def write_bytes(self, b: bytes) -> None:
        self.write_long(len(b))
        self.out.write(b)

    def write_string(self, s: str) -> None:
        self.write_bytes(s.encode("utf-8"))


def encode_long(n: int) -> bytes:
    """The zigzag varint of ``n`` (what :meth:`BinaryEncoder.write_long`
    writes)."""
    n = (n << 1) ^ (n >> 63)
    out = bytearray()
    while (n & ~0x7F) != 0:
        out.append(n & 0x7F | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


class EncodedArray(bytes):
    """An array datum already in Avro binary form (its block and the closing
    0), written as it is and taken as the array branch of a union: the bulk
    path of wide arrays, the model writers' coefficient lists."""


class BinaryDecoder:
    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def read_long(self) -> int:
        shift = 0
        acc = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)  # un-zigzag

    read_int = read_long

    def read_null(self):
        return None

    def read_boolean(self) -> bool:
        b = self.buf[self.pos]
        self.pos += 1
        return b != 0

    def read_float(self) -> float:
        v = struct.unpack_from("<f", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def read_double(self) -> float:
        v = struct.unpack_from("<d", self.buf, self.pos)[0]
        self.pos += 8
        return v

    def read_bytes(self) -> bytes:
        n = self.read_long()
        v = self.buf[self.pos : self.pos + n]
        self.pos += n
        return v

    def read_string(self) -> str:
        return self.read_bytes().decode("utf-8")


# ---------------------------------------------------------------------------
# Datum read/write
# ---------------------------------------------------------------------------


def _schema_type(schema: SchemaType) -> str:
    if isinstance(schema, str):
        return schema
    if isinstance(schema, list):
        return "union"
    t = schema["type"]
    return t if isinstance(t, str) else _schema_type(t)


def write_datum(enc: BinaryEncoder, schema: SchemaType, datum: Any) -> None:
    t = _schema_type(schema)
    if t == "null":
        enc.write_null()
    elif t == "boolean":
        enc.write_boolean(bool(datum))
    elif t in ("int", "long"):
        enc.write_long(int(datum))
    elif t == "float":
        enc.write_float(float(datum))
    elif t == "double":
        enc.write_double(float(datum))
    elif t == "bytes":
        enc.write_bytes(bytes(datum))
    elif t == "string":
        enc.write_string(str(datum))
    elif t == "fixed":
        enc.out.write(bytes(datum))
    elif t == "enum":
        enc.write_long(schema["symbols"].index(datum))
    elif t == "union":
        idx = _pick_union_branch(schema, datum)
        enc.write_long(idx)
        write_datum(enc, schema[idx], datum)
    elif t == "array":
        if isinstance(datum, EncodedArray):
            enc.out.write(datum)
            return
        items = list(datum)
        if items:
            enc.write_long(len(items))
            for it in items:
                write_datum(enc, schema["items"], it)
        enc.write_long(0)
    elif t == "map":
        entries = dict(datum)
        if entries:
            enc.write_long(len(entries))
            for k, v in entries.items():
                enc.write_string(k)
                write_datum(enc, schema["values"], v)
        enc.write_long(0)
    elif t == "record":
        for f in schema["fields"]:
            name = f["name"]
            if name in datum:
                value = datum[name]
            elif "default" in f:
                value = f["default"]
            else:
                raise ValueError(
                    f"missing field {name!r} for record {schema.get('name')}"
                )
            write_datum(enc, f["type"], value)
    else:
        raise ValueError(f"unsupported type: {t}")


def _pick_union_branch(union: list, datum: Any) -> int:
    def matches(s: SchemaType) -> bool:
        st = _schema_type(s)
        if datum is None:
            return st == "null"
        if isinstance(datum, bool):
            return st == "boolean"
        if isinstance(datum, int):
            return st in ("int", "long", "float", "double")
        if isinstance(datum, float):
            return st in ("float", "double")
        if isinstance(datum, str):
            return st in ("string", "enum")
        if isinstance(datum, EncodedArray):
            return st == "array"
        if isinstance(datum, bytes):
            return st in ("bytes", "fixed")
        if isinstance(datum, dict):
            return st in ("record", "map")
        if isinstance(datum, (list, tuple)):
            return st == "array"
        return False

    for i, s in enumerate(union):
        if matches(s):
            return i
    raise ValueError(f"no union branch for {type(datum)} in {union}")


def read_datum(dec: BinaryDecoder, schema: SchemaType) -> Any:
    t = _schema_type(schema)
    if t == "null":
        return None
    if t == "boolean":
        return dec.read_boolean()
    if t in ("int", "long"):
        return dec.read_long()
    if t == "float":
        return dec.read_float()
    if t == "double":
        return dec.read_double()
    if t == "bytes":
        return dec.read_bytes()
    if t == "string":
        return dec.read_string()
    if t == "fixed":
        size = schema["size"]
        v = dec.buf[dec.pos : dec.pos + size]
        dec.pos += size
        return v
    if t == "enum":
        return schema["symbols"][dec.read_long()]
    if t == "union":
        return read_datum(dec, schema[dec.read_long()])
    if t == "array":
        out: List[Any] = []
        while True:
            n = dec.read_long()
            if n == 0:
                break
            if n < 0:  # block with byte size
                n = -n
                dec.read_long()
            for _ in range(n):
                out.append(read_datum(dec, schema["items"]))
        return out
    if t == "map":
        entries: Dict[str, Any] = {}
        while True:
            n = dec.read_long()
            if n == 0:
                break
            if n < 0:
                n = -n
                dec.read_long()
            for _ in range(n):
                k = dec.read_string()
                entries[k] = read_datum(dec, schema["values"])
        return entries
    if t == "record":
        return {f["name"]: read_datum(dec, f["type"]) for f in schema["fields"]}
    raise ValueError(f"unsupported type: {t}")


# ---------------------------------------------------------------------------
# Object container files
# ---------------------------------------------------------------------------


def write_container(
    path: str,
    schema: Union[str, SchemaType],
    records: Iterable[dict],
    *,
    codec: str = "deflate",
    sync_interval: int = DEFAULT_SYNC_INTERVAL,
) -> int:
    """Write an Avro object container file; returns the record count.

    Atomic: bytes land in a same-directory temp file and ``os.replace``
    publishes them, so a reader (or a resumed run) never sees a torn
    container: part files, model files and summaries are all artifacts
    a crash must not leave half-written."""
    # parse_schema mutates nested dicts while resolving references — give it
    # a copy so the caller's schema object stays pristine.
    parsed = parse_schema(
        json.loads(json.dumps(schema)) if isinstance(schema, (dict, list)) else schema
    )
    schema_json = json.dumps(schema) if isinstance(schema, (dict, list)) else schema
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported codec: {codec}")
    # DETERMINISTIC sync marker: the marker only delimits blocks (the
    # reader walks block counts/sizes and checks it), so deriving it from
    # the schema alone makes the container byte-reproducible for identical
    # records, whatever the output path, and byte-identical to the JAX
    # package's.
    sync = hashlib.blake2b(
        f"photon-avro-sync|{schema_json}".encode(), digest_size=SYNC_SIZE
    ).digest()
    count_total = 0
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with atomic_writer(path, "wb") as f:
        f.write(MAGIC)
        meta_enc = BinaryEncoder(f)
        write_datum(
            meta_enc,
            {"type": "map", "values": "bytes"},
            {
                "avro.schema": schema_json.encode("utf-8"),
                "avro.codec": codec.encode("utf-8"),
            },
        )
        f.write(sync)

        buf = io.BytesIO()
        enc = BinaryEncoder(buf)
        block_count = 0

        def flush_block():
            nonlocal block_count, count_total
            if block_count == 0:
                return
            raw = buf.getvalue()
            payload = (
                raw if codec == "null" else zlib.compress(raw)[2:-4]
            )  # deflate = zlib minus header/checksum
            out = BinaryEncoder(f)
            out.write_long(block_count)
            out.write_long(len(payload))
            f.write(payload)
            f.write(sync)
            count_total += block_count
            block_count = 0
            buf.seek(0)
            buf.truncate()

        for rec in records:
            write_datum(enc, parsed, rec)
            block_count += 1
            if buf.tell() >= sync_interval:
                flush_block()
        flush_block()
    return count_total


def read_container(path: str) -> Tuple[SchemaType, Iterator[dict]]:
    """Read an Avro object container file -> (schema, record iterator)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != MAGIC:
        raise ValueError(f"{path}: not an Avro container file")
    dec = BinaryDecoder(data, 4)
    meta = read_datum(dec, {"type": "map", "values": "bytes"})
    schema = parse_schema(meta["avro.schema"].decode("utf-8"))
    codec = meta.get("avro.codec", b"null").decode("utf-8")
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported codec: {codec}")
    sync = data[dec.pos : dec.pos + SYNC_SIZE]
    dec.pos += SYNC_SIZE

    def it() -> Iterator[dict]:
        pos = dec.pos
        while pos < len(data):
            d = BinaryDecoder(data, pos)
            n = d.read_long()
            size = d.read_long()
            block = data[d.pos : d.pos + size]
            d.pos += size
            if data[d.pos : d.pos + SYNC_SIZE] != sync:
                raise ValueError(f"{path}: sync marker mismatch")
            pos = d.pos + SYNC_SIZE
            if codec == "deflate":
                block = zlib.decompress(block, -15)
            bd = BinaryDecoder(block)
            for _ in range(n):
                yield read_datum(bd, schema)

    return schema, it()


def read_container_schema(path: str) -> SchemaType:
    """Parse ONLY the header schema without slurping the whole file —
    reads a growing prefix until the metadata map decodes cleanly."""
    size = 1 << 16
    while True:
        with open(path, "rb") as f:
            data = f.read(size)
        if data[:4] != MAGIC:
            raise ValueError(f"{path}: not an Avro container file")
        try:
            dec = BinaryDecoder(data, 4)
            meta = read_datum(dec, {"type": "map", "values": "bytes"})
            if dec.pos > len(data):
                raise IndexError("truncated header")
            return parse_schema(meta["avro.schema"].decode("utf-8"))
        except (IndexError, KeyError, UnicodeDecodeError, ValueError) as e:
            if len(data) < size:  # whole file read and still bad
                raise ValueError(f"{path}: bad container header") from e
            size *= 4


def read_avro_records(paths: Union[str, List[str]]) -> Iterator[dict]:
    """Iterate records across one or many container files / directories
    (AvroUtils.readAvroFiles analog; directories expand to their *.avro,
    skipping hidden/marker files)."""
    for p in expand_input_paths(paths, lambda fn: fn.endswith(".avro")):
        _, it = read_container(p)
        yield from it
