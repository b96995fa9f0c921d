"""PL018 wire-contract completeness: the binary wire plane's message
inventory is cross-checked end to end, PL011-style. Every ``MSG_*``
constant in ``serving/wire.py`` must have

* an **encoder** — a function calling ``append_frame(buf, MSG_X, ...)``,
* a **decoder** — a ``decode*`` branch referencing the constant,
* a **dispatch** reference in the frontend or the transport
  (``serving/frontend.py`` / ``serving/routing.py``) — a frame type
  nobody routes is either dead or, worse, silently falls through a
  response-side ``decode_message`` and can confuse the protocol,
* a **fuzz-corpus entry** — a ``wire.MSG_X`` key in
  ``tests/test_torch_wire.py``'s ``WIRE_FUZZ_CORPUS`` dict, so the corpus
  can never silently lag a new message type;

and every named ``WireError`` kind must appear in the frontend (the
BAD_REQUEST mapping leg). The inventory is machine-built by
``lint/determinism.py`` and exported under ``--json`` as
``wire_contract``. NEVER_BASELINE: a half-wired message type is a
protocol hole, not debt to inherit. Not allow()-suppressable.
"""

from __future__ import annotations

from typing import Iterator

from photon_ml_tpu_torch.lint import determinism
from photon_ml_tpu_torch.lint.core import (
    PackageContext,
    PackageRule,
    Violation,
    register_package,
)


def _check(pkg: PackageContext) -> Iterator[Violation]:
    contract = determinism.wire_contract(pkg)
    if contract is None:
        return
    ctx = pkg.contexts[contract.path]

    def flag(node, msg):
        return ctx.violation(RULE, node, msg, suppressable=False)

    seen_values = {}
    for msg in contract.messages:
        if msg.value in seen_values:
            yield flag(msg.node, (
                f"{msg.name} reuses wire value 0x{msg.value:02x} "
                f"already taken by {seen_values[msg.value]} — frame "
                "types must be unique"
            ))
        seen_values.setdefault(msg.value, msg.name)
        if not msg.encoders:
            yield flag(msg.node, (
                f"{msg.name} has no encoder — no function calls "
                f"append_frame(buf, {msg.name}, ...); a message type "
                "nobody can emit is dead wire surface"
            ))
        if not msg.decoded:
            yield flag(msg.node, (
                f"{msg.name} has no decoder branch — no decode* "
                "function references it, so peers that emit it get "
                "'unknown message type'"
            ))
        if not msg.dispatch:
            yield flag(msg.node, (
                f"{msg.name} is never dispatched — neither "
                "serving/frontend.py nor serving/routing.py "
                "references it, so frames of this type fall through "
                "the planes that should route or refuse them"
            ))
        if contract.corpus_checked and msg.in_corpus is False:
            yield flag(msg.node, (
                f"{msg.name} has no fuzz-corpus entry — add a "
                f"wire.{msg.name} key to WIRE_FUZZ_CORPUS in "
                "tests/test_torch_wire.py so the corpus tracks the "
                "inventory"
            ))
    if contract.corpus_checked and contract.corpus_node is None:
        yield flag(ctx.tree, (
            "tests/test_torch_wire.py exists but defines no "
            "WIRE_FUZZ_CORPUS dict — the fuzz corpus must be keyed "
            "by wire.MSG_* so PL018 can cross-check coverage"
        ))
    for kind, mapped in sorted(contract.error_kinds.items()):
        if not mapped:
            yield flag(ctx.tree, (
                f"WireError kind '{kind}' has no frontend mapping — "
                "serving/frontend.py never names it, so the error "
                "surfaces as an unclassified failure instead of a "
                "BAD_REQUEST category"
            ))


RULE = register_package(
    PackageRule(
        id="PL018",
        slug="wire-contract-completeness",
        doc="every MSG_* type has encoder+decoder+dispatch+fuzz "
            "corpus entry; every WireError kind a frontend mapping",
        check=_check,
        group="determinism",
    )
)
