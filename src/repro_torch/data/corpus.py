"""Synthetic binary-function corpus.

The paper's dataset (202M functions compiled from nixpkgs, ~2 TB raw;
25 GB after R1) is not public.  2 TB / 202M functions ≈ 10 KB per record —
far more than the code bytes themselves, i.e. the raw records carry the
usual binary-analysis payload (disassembly text, symbol/source metadata,
per-record fields), and R1's 99% reduction comes from keeping ONLY the
token ids + attention masks.  This generator reproduces that record shape:

  raw record  = JSON {name, package, compiler, flags, source_path,
                      disassembly text, hex dump, cfg edges}
  packed data = uint16 token ids of the code bytes + attention mask

so the measured reduction is structurally comparable to the paper's.
"""
from __future__ import annotations

import json
import os
from typing import Iterator

import numpy as np

# a tiny "ISA": opcode-ish byte patterns with operand bytes, so byte
# statistics are skewed like real compiled code rather than uniform noise.
_OPCODES = np.array([0x55, 0x48, 0x89, 0x8B, 0xE8, 0xC3, 0x90, 0x41, 0x83,
                     0x0F, 0x74, 0x75, 0xEB, 0x5D, 0x31, 0xFF], np.uint8)
_MNEMONIC = {0x55: "push", 0x48: "rex.w", 0x89: "mov", 0x8B: "mov",
             0xE8: "call", 0xC3: "ret", 0x90: "nop", 0x41: "rex.b",
             0x83: "add", 0x0F: "esc", 0x74: "je", 0x75: "jne",
             0xEB: "jmp", 0x5D: "pop", 0x31: "xor", 0xFF: "grp5"}
_PKGS = ["glibc", "openssl", "coreutils", "ffmpeg", "sqlite", "zlib",
         "curl", "python3", "gcc", "binutils"]


def synth_function(rng: np.random.Generator, mean_len: float = 180.0) -> bytes:
    n = max(8, int(rng.lognormal(np.log(mean_len), 0.9)))
    ops = rng.choice(_OPCODES, size=n)
    operands = (rng.integers(0, 256, size=n) * (rng.random(n) < 0.35)).astype(np.uint8)
    interleaved = np.empty(2 * n, np.uint8)
    interleaved[0::2] = ops
    interleaved[1::2] = operands
    # ~half the operand slots are zero -> repetition, like padding/relocs
    return interleaved.tobytes()


def synth_record(rng: np.random.Generator, idx: int,
                 mean_len: float = 180.0) -> dict:
    code = synth_function(rng, mean_len)
    ops = code[0::2]
    operands = code[1::2]
    disasm = "\n".join(
        f"{2 * i:08x}:  {op:02x} {operand:02x}"
        f"    {_MNEMONIC.get(op, 'db')} 0x{operand:x}"
        for i, (op, operand) in enumerate(zip(ops, operands))
    )
    pkg = _PKGS[int(rng.integers(0, len(_PKGS)))]
    n_edges = max(1, len(code) // 40)
    return {
        "name": f"fn_{idx:09d}",
        "package": pkg,
        "compiler": "gcc-13.2.0",
        "flags": "-O2 -fPIC -fstack-protector-strong",
        "source_path": f"/nix/store/{pkg}/src/{pkg}-{idx % 97}.c",
        "code_hex": code.hex(),
        "disassembly": disasm,
        "cfg_edges": [[int(rng.integers(0, n_edges)),
                       int(rng.integers(0, n_edges))]
                      for _ in range(n_edges)],
    }


def write_raw_corpus(path: str, n_functions: int, seed: int = 0,
                     mean_len: float = 180.0) -> int:
    """Writes JSONL records (the 'raw 2 TB' analogue); returns total bytes."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    rng = np.random.default_rng(seed)
    total = 0
    with open(path, "w") as f:
        for i in range(n_functions):
            line = json.dumps(synth_record(rng, i, mean_len)) + "\n"
            f.write(line)
            total += len(line)
    return total


def read_raw_corpus(path: str) -> Iterator[bytes]:
    """Yields the code bytes of each record (the only field R1 keeps)."""
    with open(path) as f:
        for line in f:
            yield bytes.fromhex(json.loads(line)["code_hex"])
