"""Columns of a CSV file with a header row, on the ``csv`` module.

What ``dream_tpu``'s plot tools read with ``pandas.read_csv`` (the port's
machine has no pandas): :func:`read_columns` maps each header name to its
column, numbers as float64 arrays.  Numbers are parsed as pandas' C parser
parses them (:func:`parse_float`, its ``precise_xstrtod``), which is not
correctly rounded: Python's ``float`` lands up to an ulp away, and the
tools' printed means would differ in their last digit.
"""

from __future__ import annotations

import csv
import re
from typing import Dict

import numpy as np

_DECIMAL = re.compile(r"\s*[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?\s*$")
# The table pandas divides and multiplies by: the double nearest each 10^k.
_POWERS = [float(f"1e{k}") for k in range(309)]


def parse_float(text: str) -> float:
    """``text`` as pandas' ``precise_xstrtod`` reads it: at most 17
    significant digits accumulated in a double (leading zeros counted),
    then scaled by one power of ten from the table.  Text that is not a
    decimal number (``nan``, ``inf``) goes to ``float``."""
    if not _DECIMAL.match(text):
        return float(text)
    s = text.strip()
    p, n = 0, len(s)
    negative = s[0] == "-"
    if s[0] in "+-":
        p += 1
    number, exponent, digits = 0.0, 0, 0
    while p < n and s[p].isdigit():
        if digits < 17:
            number = number * 10.0 + (ord(s[p]) - 48)
            digits += 1
        else:
            exponent += 1
        p += 1
    if p < n and s[p] == ".":
        p += 1
        decimals = 0
        while p < n and s[p].isdigit() and digits < 17:
            number = number * 10.0 + (ord(s[p]) - 48)
            p += 1
            digits += 1
            decimals += 1
        while p < n and s[p].isdigit():
            p += 1
        exponent -= decimals
    if negative:
        number = -number
    if p < n and s[p] in "eE":
        exponent += int(s[p + 1:])
    if exponent > 308:
        return -np.inf if negative else np.inf
    if exponent > 0:
        return number * _POWERS[exponent]
    if exponent < -308:
        return 0.0 if exponent < -616 else number / _POWERS[-308 - exponent] / _POWERS[308]
    return number / _POWERS[-exponent]


def read_columns(path: str) -> Dict[str, np.ndarray]:
    """``{name: column}`` of a CSV file whose first row names the columns;
    a column whose every cell parses as a number becomes a float64 array,
    any other a numpy array of strings."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        raise ValueError(f"{path} is empty")
    header, body = rows[0], rows[1:]
    if any(len(r) != len(header) for r in body):
        raise ValueError(f"{path}: rows and header differ in length")
    columns = {}
    for i, name in enumerate(header):
        cells = [r[i] for r in body]
        try:
            columns[name] = np.array([parse_float(c) for c in cells], np.float64)
        except ValueError:
            columns[name] = np.array(cells)
    return columns
