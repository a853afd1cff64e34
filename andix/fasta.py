"""FASTA input.

Host-side replacement for the reference's vendored pfasta parser
(``libs/pfasta.c``) and I/O plumbing (``src/io.c``).  Instead of a buffered
fd state machine with SSE2 whitespace scanning, the whole file is read once
and split with vectorized NumPy byte ops — parsing is not on the device
critical path (SURVEY.md §2.2).

Parsing rules preserved from pfasta:

* the file must start with ``>`` (``pfasta_init``),
* record name = first whitespace-delimited word after ``>`` and must be
  non-empty (``pfasta_read_name``),
* the rest of the header line is a comment (``pfasta_read_comment``),
* sequence data = all non-whitespace on subsequent lines until the next
  ``>`` header; an empty sequence is an error (``pfasta_read_sequence``).
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

from . import sequence as seqmod
from .runtime import Context


class FastaError(Exception):
    pass


@dataclasses.dataclass
class RawRecord:
    name: str
    comment: str
    data: np.ndarray  # raw uint8 sequence bytes (unnormalized)


_GT = ord(">")
_NL = ord("\n")


def _isalpha(c: int) -> bool:
    return 65 <= c <= 90 or 97 <= c <= 122


class FastaStream:
    """Chunked pfasta-exact FASTA parser (libs/pfasta.c:304-482).

    pfasta parses from a buffered fd; reading whole files into memory
    (the previous andix parser) breaks down at file-of-filenames scale
    (pneu3085: thousands of genomes).  This streams the input in bounded
    chunks through the same word-level state machine: records are a
    sequence of whitespace-delimited words; a record is a ``>``-word
    (name), the rest of that line (comment), then words starting with a
    letter, ``-`` or ``*``; any other word start ends the record and must
    be the next ``>``.  Error strings and their line numbers match pfasta
    byte for byte; records parsed before an error are still yielded (the
    reference pushes each record before the failing read,
    src/io.c:214-226).

    Iterate to receive ``RawRecord``s; after iteration ends check
    ``.error``.  Peak memory is O(chunk + one record's sequence)."""

    def __init__(self, fh, chunk_size: int = 1 << 22):
        self._fh = fh
        self._chunk = chunk_size
        self.error: str | None = None
        # persistent record state across chunks
        self._state = 0  # 0=expect '>', 1=in header line, 2=in sequence
        self._name: str | None = None
        self._comment_parts: list[bytes] = []
        self._seq_parts: list[np.ndarray] = []
        self._header_line = 0

    def __iter__(self):
        first = True
        carry = b""
        line0 = 1  # line number of carry[0]
        while True:
            data = self._fh.read(self._chunk)
            eof = not data
            buf = carry + data if carry else data
            carry = b""
            if first:
                first = False
                if eof and not buf:
                    self.error = "File is empty."
                    return
                if buf[:1] != b">":
                    self.error = "File must start with '>'."
                    return
            if not eof and buf:
                # cut at the last whitespace so no word (and, in header
                # state, no header line) is split across chunks; a
                # chunk-sized word carries over whole until EOF
                arr0 = np.frombuffer(buf, dtype=np.uint8)
                ws0 = (arr0 == 32) | ((arr0 >= 9) & (arr0 <= 13))
                idx = np.nonzero(ws0)[0]
                cut = int(idx[-1]) + 1 if len(idx) else 0
                if self._state == 1 and not (arr0[:cut] == _NL).any():
                    cut = 0  # keep accumulating the header line
                carry = buf[cut:]
                buf = buf[:cut]
            if buf:
                err, out, nl = self._parse_region(buf, line0, eof and not carry)
                yield from out
                line0 += nl
                if err is not None:
                    self.error = err
                    return
            if eof:
                break
        # EOF epilogue (carry is empty: final region was parsed with
        # eof=True; a trailing partial word was folded into that region)
        if self._state == 0 and self._name is None:
            return
        if self._state == 1:
            self.error = (
                f"Unexpected EOF in comment on line {self._header_line}."
            )
            return
        if self._state == 2:
            rec, err = self._finish_record(line0)
            if rec is not None:
                yield rec
            self.error = err

    def _finish_record(self, bad_line: int):
        if not self._seq_parts:
            return None, f"Empty sequence on line {bad_line}."
        parts = self._seq_parts
        data = parts[0] if len(parts) == 1 else np.concatenate(parts)
        rec = RawRecord(
            name=self._name,
            comment=b"".join(self._comment_parts).decode(
                "utf-8", errors="replace"
            ),
            data=data,
        )
        self._name = None
        self._comment_parts = []
        self._seq_parts = []
        self._state = 0
        return rec, None

    def _parse_region(self, blob: bytes, line0: int, at_eof: bool):
        """Parse one region of complete words.  Returns
        (errstr | None, records, newline_count)."""
        arr = np.frombuffer(blob, dtype=np.uint8)
        n = len(arr)
        ws = (arr == 32) | ((arr >= 9) & (arr <= 13))
        newline_pos = np.nonzero(arr == _NL)[0]

        def line_of(i: int) -> int:
            # a newline terminates its own line
            return line0 + int(np.searchsorted(newline_pos, i, "left"))

        eof_line = line0 + len(newline_pos)
        nl_total = len(newline_pos)

        is_start = ~ws
        is_start[1:] &= ws[:-1]
        starts = np.nonzero(is_start)[0]
        ws_idx = np.nonzero(ws)[0]
        if len(ws_idx):
            nxt = np.searchsorted(ws_idx, starts)
            ends = np.where(
                nxt < len(ws_idx),
                ws_idx[np.minimum(nxt, len(ws_idx) - 1)], n,
            )
        else:
            ends = np.full(len(starts), n, dtype=np.int64)
        # which words open a sequence part (letter, '-' or '*')
        first_b = arr[starts] if len(starts) else arr[:0]
        is_seqw = (
            ((first_b >= 65) & (first_b <= 90))
            | ((first_b >= 97) & (first_b <= 122))
            | (first_b == 45)
            | (first_b == 42)
        )

        records: list[RawRecord] = []
        W = len(starts)
        w = 0
        if self._state == 1:
            # resume a header line split across chunks (only reachable at
            # EOF or when a newline finally arrived — the chunk cutter
            # keeps buffering otherwise)
            if len(newline_pos) == 0:
                if at_eof:
                    return (
                        f"Unexpected EOF in comment on line "
                        f"{self._header_line}.",
                        records, nl_total,
                    )
                self._comment_parts.append(blob)
                return None, records, nl_total
            eol = int(newline_pos[0])
            self._comment_parts.append(blob[:eol])
            self._state = 2
            while w < W and starts[w] < eol:
                w += 1
        while True:
            if self._state == 2:
                # bulk-consume the run of sequence words from w
                stop = w
                while stop < W and is_seqw[stop]:
                    stop += 1
                if stop > w:
                    lo = int(starts[w])
                    hi = int(ends[stop - 1])
                    seg = arr[lo:hi]
                    self._seq_parts.append(seg[~ws[lo:hi]])
                    w = stop
                if w < W or at_eof:
                    bad = line_of(int(starts[w])) if w < W else eof_line
                    rec, err = self._finish_record(bad)
                    if err is not None:
                        return err, records, nl_total
                    records.append(rec)
                    continue
                return None, records, nl_total  # region exhausted mid-seq
            if w >= W:
                return None, records, nl_total
            s = int(starts[w])
            c = int(arr[s])
            if c != _GT:
                return (
                    f"Expected '>' but found '{chr(c)}' on line "
                    f"{line_of(s)}.",
                    records, nl_total,
                )
            # --- name (pfasta_read_name, libs/pfasta.c:352-386) ---
            e = int(ends[w])
            if e >= n and at_eof:  # '>' or name word runs into EOF
                return (
                    f"Unexpected EOF in name on line {line_of(s)}.",
                    records, nl_total,
                )
            if e == s + 1:
                return f"Empty name on line {line_of(s)}.", records, nl_total
            self._name = blob[s + 1 : e].decode("utf-8", errors="replace")
            self._header_line = line_of(s)
            # --- comment (pfasta_read_comment, :388-430) ---
            nl_i = int(np.searchsorted(newline_pos, e, "left"))
            if nl_i >= len(newline_pos):
                if at_eof:
                    return (
                        f"Unexpected EOF in comment on line {line_of(s)}.",
                        records, nl_total,
                    )
                # header line continues in the next chunk
                if int(arr[e]) != _NL and e < n:
                    self._comment_parts.append(blob[e + 1 :])
                self._state = 1
                return None, records, nl_total
            eol = int(newline_pos[nl_i])
            if int(arr[e]) != _NL:
                self._comment_parts.append(blob[e + 1 : eol])
            self._state = 2
            w += 1
            while w < W and starts[w] < eol:  # words inside the comment
                w += 1

    @property
    def at_record_boundary(self) -> bool:
        return self._state == 0 and self._name is None


def parse_fasta_bytes(blob: bytes):
    """Whole-blob wrapper over ``FastaStream`` (one code path — the
    malformed-input parity tests gate the streaming parser directly).
    Returns (records, errstr | None)."""
    import io

    stream = FastaStream(io.BytesIO(blob))
    records = list(stream)
    return records, stream.error


def read_fasta(file_name: str, ctx: Context) -> list[seqmod.Seq]:
    """Read and normalize all sequences of one file (reference ``read_fasta``,
    src/io.c:196-233), streaming in bounded chunks (``FastaStream``) —
    each record is normalized as it completes, so peak memory is one
    chunk plus the kept sequences, never the raw file besides them.
    Parse failures are soft errors; records parsed before the failure are
    kept, matching the reference's read loop."""
    out = []
    try:
        fh = (
            sys.stdin.buffer
            if file_name == "-"
            else open(file_name, "rb")
        )
    except OSError as e:
        ctx.soft_err(f"{file_name}: {e.strerror}")
        return []
    try:
        stream = FastaStream(fh)
        for rec in stream:
            data, non_acgt = seqmod.normalize(rec.data)
            if non_acgt:
                ctx.non_acgt = True
            out.append(seqmod.Seq(data=data, name=rec.name))
    except OSError as e:  # pragma: no cover - read error mid-stream
        ctx.soft_err(f"{file_name}: {e.strerror}")
        return out
    finally:
        if file_name != "-":
            fh.close()
    if stream.error is not None:
        ctx.soft_err(f"{file_name}: {stream.error}")
    return out


def read_fasta_join(file_name: str, ctx: Context) -> list[seqmod.Seq]:
    """Join mode: merge all contigs of a file into one sequence named after
    the file basename without extension (reference ``read_fasta_join``,
    src/io.c:159-189)."""
    singles = read_fasta(file_name, ctx)
    if not singles:
        return []
    joined = seqmod.join([s.data for s in singles])

    base = os.path.basename(file_name)
    dot = base.find(".")
    name = base if dot == -1 else base[:dot]
    return [seqmod.Seq(data=joined, name=name)]


def read_into_string_vector(file_name: str, ctx: Context) -> list[str]:
    """Read a file of file names, one per line, skipping empty lines
    (reference ``read_into_string_vector``, src/io.c:103-144)."""
    try:
        if file_name == "-":
            lines = sys.stdin.read().splitlines()
        else:
            with open(file_name, "r") as fh:
                lines = fh.read().splitlines()
    except OSError as e:
        ctx.soft_err(f"{file_name}: {e.strerror}")
        return []
    return [ln for ln in lines if ln]
