"""PII redaction UDFs (dictionary-side).

Reference parity: ``src/carnot/funcs/builtins/pii_ops.{h,cc}`` —
``RedactPIIUDF`` runs a tagger pipeline (regex taggers for IPv4/IPv6,
emails, MAC addresses, IMEI/IMEISV, credit-card numbers with a Luhn
check) and substitutes ``<REDACTED_$TYPE>``. Best-effort by the
reference's own documentation — not a privacy guarantee. Tagger
precedence matches the reference: the credit-card tagger runs before
the IMEI tagger, so a Luhn-valid 15-digit IMEI redacts under the
``<REDACTED_CC_NUMBER>`` label (still redacted, differently named).

Runs once per distinct string in the column dictionary (HOST_DICT), so
redacting a billion-row column costs O(vocabulary).
"""

from __future__ import annotations

import ipaddress
import re

from ..udf import STRING, Executor

_IPV4 = re.compile(
    r"\b(?:(?:25[0-5]|2[0-4]\d|1\d\d|[1-9]?\d)\.){3}"
    r"(?:25[0-5]|2[0-4]\d|1\d\d|[1-9]?\d)\b"
)
# Candidate colon-hex tokens; real IPv6-ness (incl. '::' compression) is
# decided by ipaddress parsing, not the regex.
_IPV6_CAND = re.compile(
    r"(?<![0-9A-Fa-f:.])([0-9A-Fa-f]*:[0-9A-Fa-f:.]+)(?![0-9A-Fa-f:.])"
)
_EMAIL = re.compile(
    r"\b[A-Za-z0-9._%+-]+@[A-Za-z0-9.-]+\.[A-Za-z]{2,}\b"
)
_MAC = re.compile(
    r"\b(?:[0-9A-Fa-f]{2}[:-]){5}[0-9A-Fa-f]{2}\b"
)
# 13-19 digits with optional space/dash separators (candidate CCs; the
# Luhn check below culls false positives, as the reference does).
_CC = re.compile(r"\b(?:\d[ -]?){12,18}\d\b")
_IMEI = re.compile(r"\b\d{2}[- ]?\d{6}[- ]?\d{6}[- ]?\d(?:\d)?\b")


def _luhn_ok(digits: str) -> bool:
    total = 0
    for i, ch in enumerate(reversed(digits)):
        d = ord(ch) - 48
        if i % 2 == 1:
            d *= 2
            if d > 9:
                d -= 9
        total += d
    return total % 10 == 0


def _redact_cc(m: re.Match) -> str:
    digits = re.sub(r"[ -]", "", m.group(0))
    if 13 <= len(digits) <= 19 and _luhn_ok(digits):
        return "<REDACTED_CC_NUMBER>"
    return m.group(0)


def _redact_imei(m: re.Match) -> str:
    # The CC tagger runs first and its 13-19-digit Luhn check subsumes
    # Luhn-valid IMEIs (reference tagger order does the same — both get
    # redacted, under the CC label). What reaches here is Luhn-failing:
    # the only safely taggable leftover is the separated 16-digit IMEISV
    # grouping, which carries no check digit.
    digits = re.sub(r"[- ]", "", m.group(0))
    if len(digits) == 16 and re.search(r"[- ]", m.group(0)):
        return "<REDACTED_IMEI>"
    return m.group(0)


def _redact_ipv6(m: re.Match) -> str:
    tok = m.group(0)
    if tok.count(":") < 2:
        return tok
    try:
        parsed = ipaddress.ip_address(tok.split("%", 1)[0])
    except ValueError:
        return tok
    return "<REDACTED_IPV6>" if parsed.version == 6 else tok


def redact_pii(s: str) -> str:
    # MAC before IPv6: 6-octet colon forms are valid colon-hex candidates.
    s = _EMAIL.sub("<REDACTED_EMAIL>", s)
    s = _MAC.sub("<REDACTED_MAC_ADDR>", s)
    s = _IPV4.sub("<REDACTED_IPV4>", s)
    s = _IPV6_CAND.sub(_redact_ipv6, s)
    s = _CC.sub(_redact_cc, s)
    s = _IMEI.sub(_redact_imei, s)
    return s


def register(reg):
    reg.scalar(
        "redact_pii_best_effort", (STRING,), STRING, redact_pii,
        executor=Executor.HOST_DICT, dict_arg=0,
        doc="Best-effort replacement of PII (emails, IPs, MAC addresses, "
            "credit cards, IMEIs) with <REDACTED_$TYPE> markers.",
    )
