"""I/O: the Avro codec and Photon schemas, LibSVM, input formats, model
I/O (port of ``photon_ml_tpu/io``).

The names below load their module on first use."""

import importlib

_EXPORTS = {
    "avro_codec": ("read_avro_records", "read_container", "write_container"),
    "input_format": (
        "AvroInputDataFormat", "LibSVMInputDataFormat", "LoadedData", "create_input_format",
        "parse_constraint_string",
    ),
}
_MODULE_OF = {name: module for module, names in _EXPORTS.items() for name in names}
__all__ = [name for names in _EXPORTS.values() for name in names]


def __getattr__(name):
    module = _MODULE_OF.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value
