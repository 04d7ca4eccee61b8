"""TFLite flatbuffers read with numpy alone: the schema tables the weight
readers need, the postprocess op's flexbuffer options, and the metadata
(normalization mean / std and packed label files).

Port of deepdish_tpu/models/tflite_meta.py (`FBTable` :32, `read_metadata`
:124, `_read_packed_file` :178). The JAX package reads the model through
TF's generated schema (`schema_py_generated`) and the postprocess options
through `flatbuffers.flexbuffers`; neither is on the card's machine, so
`FBTable`, a minimal reader of the flatbuffers wire format (little endian,
vtable / uoffset navigation), is extended here to the tables that
models/convert.py reads: Model, SubGraph, Tensor, Buffer, Operator,
OperatorCode, QuantizationParameters and Metadata. `read_model` parses a
file into plain Python values once; `loads_flexbuffer_map` decodes the
options map.

Field slots follow tensorflow/lite/schema/schema.fbs, as TF's generated
schema numbers them (vtable offset 4 + 2 * slot):
  Model: operator_codes 1, subgraphs 2, buffers 4, metadata 6
  SubGraph: tensors 0, inputs 1, outputs 2, operators 3
  Tensor: shape 0, type 1 (byte), buffer 2 (uint), name 3, quantization 4
  Buffer: data 0
  Operator: opcode_index 0 (uint), inputs 1, outputs 2,
            builtin_options_type 3 (ubyte), builtin_options 4 (table),
            custom_options 5
  OperatorCode: deprecated_builtin_code 0 (byte), custom_code 1,
                builtin_code 3 (int)
  QuantizationParameters: scale 2 (float), zero_point 3 (long),
                          quantized_dimension 6 (int)
  Metadata: name 0, buffer 1 (uint)
and the builtin option tables the integer executor (models/qgraph.py)
reads, in `OPTION_TABLES` (union type -> fields with slot, format and the
schema's default: a field a writer left out reads as that default, e.g.
a missing dilation factor is 1, not 0); and tensorflow/lite's metadata_schema.fbs for the metadata:
  ModelMetadata.subgraph_metadata = field 3
  SubGraphMetadata.input_tensor_metadata = field 2
  TensorMetadata.process_units = field 4, .associated_files = field 6
  ProcessUnit.options_type = field 0 (union: 1 = NormalizationOptions)
  ProcessUnit.options = field 1
  NormalizationOptions.mean = field 0, .std = field 1
  AssociatedFile.name = field 0, .type = field 2
The metadata's associated files are read from the ZIP archive that the
metadata packer appends to the .tflite file (zipfile finds the central
directory at EOF regardless of the flatbuffer prefix).
"""
from __future__ import annotations

import io
import struct
import zipfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


class FBTable:
    """Minimal flatbuffers table reader (little-endian wire format)."""

    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = pos

    @classmethod
    def root(cls, buf: bytes):
        (off,) = struct.unpack_from("<I", buf, 0)
        return cls(buf, off)

    def _field_pos(self, slot: int) -> Optional[int]:
        (soff,) = struct.unpack_from("<i", self.buf, self.pos)
        vtable = self.pos - soff
        (vsize,) = struct.unpack_from("<H", self.buf, vtable)
        entry = 4 + 2 * slot
        if entry + 2 > vsize:
            return None
        (foff,) = struct.unpack_from("<H", self.buf, vtable + entry)
        if foff == 0:
            return None
        return self.pos + foff

    def scalar(self, slot: int, fmt: str, default=0):
        p = self._field_pos(slot)
        if p is None:
            return default
        return struct.unpack_from(fmt, self.buf, p)[0]

    def _indirect(self, p: int) -> int:
        (uoff,) = struct.unpack_from("<I", self.buf, p)
        return p + uoff

    def raw_string(self, slot: int) -> Optional[bytes]:
        p = self._field_pos(slot)
        if p is None:
            return None
        sp = self._indirect(p)
        (n,) = struct.unpack_from("<I", self.buf, sp)
        return bytes(self.buf[sp + 4:sp + 4 + n])

    def string(self, slot: int) -> Optional[str]:
        s = self.raw_string(slot)
        return None if s is None else s.decode("utf-8", "replace")

    def table(self, slot: int) -> Optional["FBTable"]:
        p = self._field_pos(slot)
        if p is None:
            return None
        return FBTable(self.buf, self._indirect(p))

    def _vector(self, slot: int):
        p = self._field_pos(slot)
        if p is None:
            return None
        vp = self._indirect(p)
        (n,) = struct.unpack_from("<I", self.buf, vp)
        return vp + 4, n

    def vector_tables(self, slot: int) -> List["FBTable"]:
        v = self._vector(slot)
        if v is None:
            return []
        base, n = v
        return [FBTable(self.buf, self._indirect(base + 4 * i))
                for i in range(n)]

    def vector(self, slot: int, dtype: str) -> Optional[np.ndarray]:
        """A vector of scalars as a numpy array (a copy), None when the
        field is absent; dtype is a little-endian numpy code ('<f4')."""
        v = self._vector(slot)
        if v is None:
            return None
        base, n = v
        return np.frombuffer(self.buf, np.dtype(dtype), n, base).copy()

    def vector_f32(self, slot: int) -> Optional[np.ndarray]:
        return self.vector(slot, "<f4")


# ------------------------------------------------------------ TFLite model

@dataclass
class Quantization:
    """QuantizationParameters: per-tensor or per-axis (quantized_dimension)
    scales and zero points, as stored (float32, int64)."""
    scale: Optional[np.ndarray]
    zero_point: Optional[np.ndarray]
    quantized_dimension: int = 0


@dataclass
class Tensor:
    name: str
    type: int                        # TensorType enum (0 = FLOAT32, ...)
    shape: Optional[np.ndarray]      # int32; None when absent
    buffer: int
    quantization: Optional[Quantization]


@dataclass
class Operator:
    opcode_index: int
    inputs: List[int]
    outputs: List[int]
    custom_options: Optional[bytes]
    builtin_options_type: int = 0    # BuiltinOptions union type, 0 = NONE
    builtin_options: Dict[str, object] = field(default_factory=dict)


# BuiltinOptions union type -> (table name, [(field, slot, struct format,
# schema default)]), from tensorflow/lite/schema/schema.fbs. Padding and
# ActivationFunctionType are byte enums (Padding: SAME 0, VALID 1).
OPTION_TABLES = {
    1: ("Conv2DOptions", [
        ("padding", 0, "<b", 0), ("stride_w", 1, "<i", 0),
        ("stride_h", 2, "<i", 0), ("fused_activation_function", 3, "<b", 0),
        ("dilation_w_factor", 4, "<i", 1), ("dilation_h_factor", 5, "<i", 1),
        ("quantized_bias_type", 6, "<b", 0)]),
    2: ("DepthwiseConv2DOptions", [
        ("padding", 0, "<b", 0), ("stride_w", 1, "<i", 0),
        ("stride_h", 2, "<i", 0), ("depth_multiplier", 3, "<i", 0),
        ("fused_activation_function", 4, "<b", 0),
        ("dilation_w_factor", 5, "<i", 1), ("dilation_h_factor", 6, "<i", 1)]),
    5: ("Pool2DOptions", [
        ("padding", 0, "<b", 0), ("stride_w", 1, "<i", 0),
        ("stride_h", 2, "<i", 0), ("filter_width", 3, "<i", 0),
        ("filter_height", 4, "<i", 0),
        ("fused_activation_function", 5, "<b", 0)]),
    8: ("FullyConnectedOptions", [
        ("fused_activation_function", 0, "<b", 0),
        ("weights_format", 1, "<b", 0), ("keep_num_dims", 2, "<?", False),
        ("asymmetric_quantize_inputs", 3, "<?", False),
        ("quantized_bias_type", 4, "<b", 0)]),
    9: ("SoftmaxOptions", [("beta", 0, "<f", 0.0)]),
    10: ("ConcatenationOptions", [
        ("axis", 0, "<i", 0), ("fused_activation_function", 1, "<b", 0)]),
    11: ("AddOptions", [
        ("fused_activation_function", 0, "<b", 0),
        ("pot_scale_int16", 1, "<?", True)]),
    21: ("MulOptions", [("fused_activation_function", 0, "<b", 0)]),
    28: ("SubOptions", [
        ("fused_activation_function", 0, "<b", 0),
        ("pot_scale_int16", 1, "<?", True)]),
    32: ("StridedSliceOptions", [
        ("begin_mask", 0, "<i", 0), ("end_mask", 1, "<i", 0),
        ("ellipsis_mask", 2, "<i", 0), ("new_axis_mask", 3, "<i", 0),
        ("shrink_axis_mask", 4, "<i", 0), ("offset", 5, "<?", False)]),
    74: ("ResizeNearestNeighborOptions", [
        ("align_corners", 0, "<?", False),
        ("half_pixel_centers", 1, "<?", False)]),
}


def read_options(kind: int, table: Optional[FBTable]) -> Dict[str, object]:
    """The builtin options table of union type `kind` as {field: value},
    each absent field at the schema's default; {} for a type not in
    OPTION_TABLES (the executor reads no options of those ops)."""
    spec = OPTION_TABLES.get(kind)
    if spec is None:
        return {}
    if table is None:
        return {name: default for name, _, _, default in spec[1]}
    return {name: table.scalar(slot, fmt, default)
            for name, slot, fmt, default in spec[1]}


@dataclass
class OperatorCode:
    builtin_code: int
    deprecated_builtin_code: int
    custom_code: Optional[bytes]

    @property
    def code(self) -> int:
        """The operator's builtin code: schema v3a keeps codes below 127
        in the deprecated byte field as well (max of the two)."""
        return int(max(self.builtin_code, self.deprecated_builtin_code))


@dataclass
class Model:
    """Subgraph 0 of a .tflite flatbuffer with the model-level tables.
    `buffers[i]` is the buffer's data (None when empty), `metadata` the
    (name, buffer index) pairs."""
    opcodes: List[OperatorCode]
    tensors: List[Tensor]
    operators: List[Operator]
    inputs: List[int]
    outputs: List[int]
    buffers: List[Optional[bytes]]
    metadata: List[tuple]

    def data(self, ti: int) -> Optional[bytes]:
        """The constant data of tensor ti, None when it has none."""
        return self.buffers[self.tensors[ti].buffer]


def _ints(t: FBTable, slot: int) -> List[int]:
    v = t.vector(slot, "<i4")
    return [] if v is None else [int(x) for x in v]


def _quantization(t: Optional[FBTable]) -> Optional[Quantization]:
    if t is None:
        return None
    return Quantization(scale=t.vector(2, "<f4"),
                        zero_point=t.vector(3, "<i8"),
                        quantized_dimension=t.scalar(6, "<i", 0))


def parse_model(buf: bytes) -> Model:
    """Parse a .tflite flatbuffer (bytes) into a `Model`; ValueError when
    the bytes are not one."""
    try:
        return _parse_model(buf)
    except (struct.error, IndexError, UnicodeDecodeError) as e:
        raise ValueError(f"not a TFLite flatbuffer ({e})") from e


def _parse_model(buf: bytes) -> Model:
    root = FBTable.root(buf)
    opcodes = [OperatorCode(builtin_code=oc.scalar(3, "<i", 0),
                            deprecated_builtin_code=oc.scalar(0, "<b", 0),
                            custom_code=oc.raw_string(1))
               for oc in root.vector_tables(1)]
    buffers = []
    for b in root.vector_tables(4):
        v = b._vector(0)
        buffers.append(None if v is None or v[1] == 0
                       else bytes(buf[v[0]:v[0] + v[1]]))
    metadata = [(m.raw_string(0), m.scalar(1, "<I", 0))
                for m in root.vector_tables(6)]
    subgraphs = root.vector_tables(2)
    if not subgraphs:
        raise ValueError("not a TFLite flatbuffer (no subgraph)")
    sg = subgraphs[0]
    tensors = [Tensor(name=t.raw_string(3).decode(),
                      type=t.scalar(1, "<b", 0),
                      shape=t.vector(0, "<i4"),
                      buffer=t.scalar(2, "<I", 0),
                      quantization=_quantization(t.table(4)))
               for t in sg.vector_tables(0)]
    operators = [Operator(opcode_index=op.scalar(0, "<I", 0),
                          inputs=_ints(op, 1), outputs=_ints(op, 2),
                          custom_options=op.raw_string(5),
                          builtin_options_type=op.scalar(3, "<B", 0),
                          builtin_options=read_options(
                              op.scalar(3, "<B", 0), op.table(4)))
                 for op in sg.vector_tables(3)]
    return Model(opcodes, tensors, operators, _ints(sg, 1), _ints(sg, 2),
                 buffers, metadata)


def read_model(model_path: str) -> Model:
    with open(model_path, "rb") as f:
        return parse_model(f.read())


# ------------------------------------------------------------ flexbuffers

_FLEX_INT, _FLEX_UINT, _FLEX_FLOAT = 1, 2, 3
_FLEX_IND_INT, _FLEX_IND_UINT, _FLEX_IND_FLOAT = 6, 7, 8
_FLEX_MAP, _FLEX_BOOL = 9, 26
_INT_FMT = {1: "<b", 2: "<h", 4: "<i", 8: "<q"}
_UINT_FMT = {1: "<B", 2: "<H", 4: "<I", 8: "<Q"}
_FLOAT_FMT = {4: "<f", 8: "<d"}


def _flex_read(buf: bytes, pos: int, width: int, fmts: Dict[int, str]):
    fmt = fmts.get(width)
    if fmt is None:
        raise ValueError(f"flexbuffer scalar of byte width {width}")
    return struct.unpack_from(fmt, buf, pos)[0]


def _flex_scalar(buf: bytes, pos: int, parent_width: int, packed: int):
    """One map value: an inline or indirect int / uint / float, or a bool,
    as flexbuffers.Loads returns it. Any other type raises."""
    ftype, width = packed >> 2, 1 << (packed & 3)
    if ftype == _FLEX_INT:
        return _flex_read(buf, pos, parent_width, _INT_FMT)
    if ftype == _FLEX_UINT:
        return _flex_read(buf, pos, parent_width, _UINT_FMT)
    if ftype == _FLEX_FLOAT:
        return float(_flex_read(buf, pos, parent_width, _FLOAT_FMT))
    if ftype == _FLEX_BOOL:
        return bool(_flex_read(buf, pos, parent_width, _UINT_FMT))
    if ftype in (_FLEX_IND_INT, _FLEX_IND_UINT, _FLEX_IND_FLOAT):
        at = pos - _flex_read(buf, pos, parent_width, _UINT_FMT)
        fmts = {_FLEX_IND_INT: _INT_FMT, _FLEX_IND_UINT: _UINT_FMT,
                _FLEX_IND_FLOAT: _FLOAT_FMT}[ftype]
        v = _flex_read(buf, at, width, fmts)
        return float(v) if ftype == _FLEX_IND_FLOAT else v
    raise ValueError(f"flexbuffer map value of type {ftype}: only int, "
                     "uint, float and bool scalars are read")


def loads_flexbuffer_map(buf: bytes) -> Dict[str, object]:
    """Decode a flexbuffer whose root is a map of scalars (the options of
    TFLite_Detection_PostProcess): {key: int | float | bool}, what
    flatbuffers.flexbuffers.Loads returns for it. The root's byte width is
    the last byte and its packed type the one before; a map stores its
    keys vector (typed keys: offsets back to NUL-terminated strings) and
    the keys' byte width before its length, then the values, then one
    packed type byte per value. Raises ValueError on anything else."""
    buf = bytes(buf)
    if len(buf) < 3:
        raise ValueError("flexbuffer too short")
    root_width, packed = buf[-1], buf[-2]
    if root_width not in _UINT_FMT:
        raise ValueError(f"flexbuffer root byte width {root_width}")
    if packed >> 2 != _FLEX_MAP:
        raise ValueError(f"flexbuffer root of type {packed >> 2}, not a map")
    root = len(buf) - 2 - root_width
    width = 1 << (packed & 3)
    mp = root - _flex_read(buf, root, root_width, _UINT_FMT)
    n = _flex_read(buf, mp - width, width, _UINT_FMT)
    keys_width = _flex_read(buf, mp - 2 * width, width, _UINT_FMT)
    keys = mp - 3 * width - _flex_read(buf, mp - 3 * width, width, _UINT_FMT)
    out = {}
    for i in range(n):
        kp = keys + i * keys_width
        ks = kp - _flex_read(buf, kp, keys_width, _UINT_FMT)
        end = buf.index(b"\0", ks)
        key = buf[ks:end].decode()
        out[key] = _flex_scalar(buf, mp + i * width, width,
                                buf[mp + n * width + i])
    return out


# ------------------------------------------------------------ metadata

def _metadata_buffer(model_path: str) -> Optional[bytes]:
    """The TFLITE_METADATA buffer of the model flatbuffer."""
    model = read_model(model_path)
    for name, bi in model.metadata:
        if name and name.decode() == "TFLITE_METADATA" \
                and model.buffers[bi] is not None:
            return model.buffers[bi]
    return None


# AssociatedFileType enum values that carry per-class labels
_LABEL_FILE_TYPES = (2, 3)   # TENSOR_AXIS_LABELS, TENSOR_VALUE_LABELS


def read_metadata(model_path: str) -> Dict:
    """Returns only the fields actually present in the flatbuffer metadata
    (a subset of {"mean", "std", "label_file", "labels"}), so callers'
    family-specific defaults survive when a piece is absent: the reference
    falls back to 127.5/127.5 only when NormalizationOptions is missing
    (tflite_object_detector.py:123-131), and EfficientDet-Lite exports
    document mean 127 / std 128."""
    out: Dict = {}
    meta = _metadata_buffer(model_path)
    if meta is None:
        return out
    root = FBTable.root(meta)
    subgraphs = root.vector_tables(3)          # ModelMetadata.subgraph_metadata
    if not subgraphs:
        return out
    sg = subgraphs[0]
    inputs = sg.vector_tables(2)               # input_tensor_metadata
    if inputs:
        t = inputs[0]
        for pu in t.vector_tables(4):          # process_units
            if pu.scalar(0, "<B", 0) == 1:     # NormalizationOptions
                opts = pu.table(1)
                if opts is not None:
                    mean = opts.vector_f32(0)
                    std = opts.vector_f32(1)
                    if mean is not None:
                        out["mean"] = [float(x) for x in mean]
                    if std is not None:
                        out["std"] = [float(x) for x in std]
        # input tensors don't carry labels; fall through
    for t in sg.vector_tables(3):              # output_tensor_metadata
        for af in t.vector_tables(6):          # associated_files
            if af.scalar(2, "<b", 0) in _LABEL_FILE_TYPES:
                out["label_file"] = af.string(0)
                break
        if out.get("label_file"):
            break
    if not out.get("label_file"):
        # some packers attach the labels at the subgraph/model level
        for holder in ([sg] + [root]):
            for af in holder.vector_tables(4 if holder is sg else 6):
                name = af.string(0)
                if name and name.endswith(".txt"):
                    out["label_file"] = name
                    break
            if out.get("label_file"):
                break
    if out.get("label_file"):
        labels = _read_packed_file(model_path, out["label_file"])
        if labels:
            out["labels"] = labels
    return out


def _read_packed_file(model_path: str, name: str) -> Optional[List[str]]:
    """Associated files live in a ZIP appended to the .tflite."""
    try:
        with open(model_path, "rb") as f:
            data = f.read()
        with zipfile.ZipFile(io.BytesIO(data)) as z:
            for zn in z.namelist():
                if zn == name or zn.endswith("/" + name):
                    text = z.read(zn).decode("utf-8", "replace")
                    return [ln.strip() for ln in text.splitlines()
                            if ln.strip()]
    except (zipfile.BadZipFile, KeyError, OSError):
        return None
    return None
