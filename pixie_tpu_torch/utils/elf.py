"""Minimal ELF symbol reader: address -> symbol resolution.

Reference parity: the object tools the continuous profiler uses to
symbolize native frames (``src/stirling/obj_tools/
elf_reader.h`` — parse .symtab/.dynsym, binary-search FUNC symbols by
address). Pure-Python struct parsing, 64-bit little-endian ELF (the
only flavor this framework deploys on); no DWARF line info — symbol
granularity is what flamegraphs need.
"""

from __future__ import annotations

import bisect
import struct
from dataclasses import dataclass

_EHDR = struct.Struct("<16sHHIQQQIHHHHHH")
_SHDR = struct.Struct("<IIQQQQIIQQ")
_SYM = struct.Struct("<IBBHQQ")

_SHT_SYMTAB = 2
_SHT_DYNSYM = 11
_STT_FUNC = 2


class ELFError(ValueError):
    pass


@dataclass(frozen=True)
class Symbol:
    name: str
    addr: int
    size: int


class ELFReader:
    """Parses symbols once; ``addr_to_symbol`` binary-searches FUNCs."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self._data = f.read()
        d = self._data
        if len(d) < _EHDR.size or d[:4] != b"\x7fELF":
            raise ELFError(f"{path}: not an ELF file")
        if d[4] != 2 or d[5] != 1:
            raise ELFError(f"{path}: only 64-bit little-endian supported")
        (_ident, _type, _machine, _ver, _entry, _phoff, shoff, _flags,
         _ehsize, _phes, _phnum, shentsize, shnum, _shstrndx) = _EHDR.unpack_from(d, 0)
        self.symbols: list[Symbol] = []
        seen = set()
        for i in range(shnum):
            off = shoff + i * shentsize
            (_name, sh_type, _fl, _addr, sh_off, sh_size, sh_link, _info,
             _align, sh_entsize) = _SHDR.unpack_from(d, off)
            if sh_type not in (_SHT_SYMTAB, _SHT_DYNSYM) or sh_entsize == 0:
                continue
            # linked string table section
            stroff = shoff + sh_link * shentsize
            (_n, _t, _f, _a, str_off, str_size, _l, _i2, _al, _es) = _SHDR.unpack_from(d, stroff)
            strtab = d[str_off:str_off + str_size]
            for j in range(sh_size // sh_entsize):
                name_i, info, _other, _shndx, value, size = _SYM.unpack_from(
                    d, sh_off + j * sh_entsize
                )
                if info & 0xF != _STT_FUNC or value == 0:
                    continue
                end = strtab.find(b"\0", name_i)
                name = strtab[name_i:end].decode("latin-1")
                if not name or (value, name) in seen:
                    continue
                seen.add((value, name))
                self.symbols.append(Symbol(name, value, size))
        self.symbols.sort(key=lambda s: s.addr)
        self._addrs = [s.addr for s in self.symbols]

    def addr_to_symbol(self, addr: int) -> str | None:
        """Symbol containing ``addr`` (ElfReader::AddrToSymbol)."""
        i = bisect.bisect_right(self._addrs, addr) - 1
        if i < 0:
            return None
        s = self.symbols[i]
        if s.size and addr >= s.addr + s.size:
            return None
        return s.name

    def symbol_addr(self, name: str) -> int | None:
        for s in self.symbols:
            if s.name == name:
                return s.addr
        return None
