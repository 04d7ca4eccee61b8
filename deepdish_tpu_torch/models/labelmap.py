"""TF Object-Detection label-map (.pbtxt) parsing, without protobuf.

A copy of deepdish_tpu/models/labelmap.py. The reference ships a
protoc-generated module (tools/string_int_label_map_pb2.py) and parses
pbtxt label maps through it (tools/saved_model.py:70-103). The pbtxt
grammar used by label maps is trivial (repeated
`item { id: N name: "..." display_name: "..." }`), so a small text parser
removes the generated-proto dependency entirely.
"""
from __future__ import annotations

import re
from typing import Dict


def parse_pbtxt_labelmap(text: str) -> Dict[int, str]:
    """Returns {id: display_name or name}."""
    out: Dict[int, str] = {}
    for item in re.finditer(r"item\s*\{(.*?)\}", text, re.S):
        body = item.group(1)
        m_id = re.search(r"\bid\s*:\s*(\d+)", body)
        m_disp = re.search(r'display_name\s*:\s*"([^"]*)"', body)
        m_name = re.search(r'\bname\s*:\s*"([^"]*)"', body)
        if m_id:
            name = (m_disp or m_name)
            if name:
                out[int(m_id.group(1))] = name.group(1)
    return out


def load_pbtxt_labelmap(path: str) -> Dict[int, str]:
    with open(path) as f:
        return parse_pbtxt_labelmap(f.read())
