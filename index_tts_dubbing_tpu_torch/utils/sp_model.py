"""Dependency-free SentencePiece model support.

The reference tokenizes with sentencepiece (utils/front.py:244,
``SentencePieceProcessor(model_file=bpe.model)``). That library isn't in this
environment, so this module implements:

- a minimal protobuf wire-format parser for the SentencePiece ``ModelProto``
  (only the ``pieces`` field is needed: piece/score/type), plus a writer used
  by tests to fabricate tiny models;
- a BPE encoder replicating sentencepiece's default behaviour: whitespace →
  ``▁`` (U+2581) with a dummy prefix, then greedy highest-score pair merges.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

WS = "▁"  # ▁

# SentencePiece piece types (sentencepiece_model.proto)
TYPE_NORMAL = 1
TYPE_UNKNOWN = 2
TYPE_CONTROL = 3
TYPE_USER_DEFINED = 4
TYPE_BYTE = 6
TYPE_UNUSED = 5


# ---------------------------------------------------------------------------
# protobuf wire parsing (just enough for ModelProto)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    """Yield (field_number, wire_type, payload) over a message buffer."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:        # varint
            v, i = _read_varint(buf, i)
            yield fnum, wtype, v
        elif wtype == 5:      # 32-bit
            yield fnum, wtype, buf[i:i + 4]
            i += 4
        elif wtype == 1:      # 64-bit
            yield fnum, wtype, buf[i:i + 8]
            i += 8
        elif wtype == 2:      # length-delimited
            ln, i = _read_varint(buf, i)
            yield fnum, wtype, buf[i:i + ln]
            i += ln
        else:
            raise ValueError(f"unsupported wire type {wtype}")


@dataclass
class Piece:
    piece: str
    score: float
    type: int = TYPE_NORMAL


def parse_model(data: bytes) -> List[Piece]:
    pieces: List[Piece] = []
    for fnum, wtype, payload in _iter_fields(data):
        if fnum == 1 and wtype == 2:  # repeated SentencePiece pieces = 1
            piece, score, ptype = "", 0.0, TYPE_NORMAL
            for f2, w2, p2 in _iter_fields(payload):
                if f2 == 1 and w2 == 2:
                    piece = p2.decode("utf-8")
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack("<f", p2)[0]
                elif f2 == 3 and w2 == 0:
                    ptype = p2
            pieces.append(Piece(piece, score, ptype))
    return pieces


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def write_model(pieces: Sequence[Piece]) -> bytes:
    """Serialise a minimal ModelProto (tests / model fabrication)."""
    out = bytearray()
    for p in pieces:
        sub = bytearray()
        enc = p.piece.encode("utf-8")
        sub += _varint((1 << 3) | 2) + _varint(len(enc)) + enc
        sub += _varint((2 << 3) | 5) + struct.pack("<f", p.score)
        if p.type != TYPE_NORMAL:
            sub += _varint((3 << 3) | 0) + _varint(p.type)
        out += _varint((1 << 3) | 2) + _varint(len(sub)) + bytes(sub)
    return bytes(out)


# ---------------------------------------------------------------------------
# BPE encoding (sentencepiece-compatible)
# ---------------------------------------------------------------------------

class SentencePieceBPE:
    """BPE inference over a SentencePiece model.

    Replicates SentencePieceProcessor.Encode for BPE-trained models with the
    default normaliser behaviour the reference relies on (whitespace → ▁,
    add_dummy_prefix).
    """

    def __init__(self, pieces: Sequence[Piece]):
        self.pieces = list(pieces)
        self.vocab: Dict[str, int] = {p.piece: i for i, p in enumerate(self.pieces)}
        self.scores = [p.score for p in self.pieces]
        self._unk_id = next((i for i, p in enumerate(self.pieces)
                             if p.type == TYPE_UNKNOWN), 0)

    @classmethod
    def from_file(cls, path: str) -> "SentencePieceBPE":
        with open(path, "rb") as f:
            return cls(parse_model(f.read()))

    # --- sentencepiece-style API ------------------------------------------
    def get_piece_size(self) -> int:
        return len(self.pieces)

    def unk_id(self) -> int:
        return self._unk_id

    def id_to_piece(self, i):
        if isinstance(i, (list, tuple)):
            return [self.pieces[j].piece for j in i]
        return self.pieces[i].piece

    def piece_to_id(self, piece: str) -> int:
        return self.vocab.get(piece, self._unk_id)

    # --- encoding ----------------------------------------------------------
    def _bpe_symbols(self, word: str) -> List[str]:
        """Greedy highest-score pair merging within one pre-token."""
        syms = list(word)
        if not syms:
            return syms
        while True:
            best_score = None
            best_i = -1
            for i in range(len(syms) - 1):
                merged = syms[i] + syms[i + 1]
                idx = self.vocab.get(merged)
                if idx is None:
                    continue
                s = self.scores[idx]
                if best_score is None or s > best_score:
                    best_score = s
                    best_i = i
            if best_i < 0:
                break
            syms[best_i:best_i + 2] = [syms[best_i] + syms[best_i + 1]]
        return syms

    def encode_as_pieces(self, text: str) -> List[str]:
        if not text:
            return []
        s = text.replace(" ", WS)
        if not s.startswith(WS):
            s = WS + s
        out: List[str] = []
        for sym in self._bpe_symbols(s):
            if sym in self.vocab:
                out.append(sym)
            else:
                # unk: sentencepiece emits per-character unknowns
                for ch in sym:
                    out.append(ch if ch in self.vocab else "<unk>")
        return out

    def encode(self, text: str, out_type=int):
        pieces = self.encode_as_pieces(text)
        if out_type is str:
            return pieces
        return [self.piece_to_id(p) for p in pieces]

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.pieces[i].piece for i in ids
                       if self.pieces[i].type == TYPE_NORMAL
                       or self.pieces[i].type == TYPE_USER_DEFINED)
        return text.replace(WS, " ").strip()
