"""Minimal DWARF (v4/v5) reader: function prototypes + struct layouts.

Reference parity: ``src/stirling/obj_tools/
dwarf_reader.h:148`` — ``GetFunctionArgInfo`` / ``GetStructMemberInfo``
/ ``GetStructSpec``, the debug-info layer the dynamic tracer's
"dwarvifier" rests on (``dynamic_tracer/.../dwarvifier.h``): resolving a
probed function's argument names, types, sizes and frame offsets so a
tracepoint can capture them. The reference links LLVM's DWARF library;
this is a self-contained pure-Python parser for the subset that powers
those three calls, for 64-bit little-endian ELF with 32-bit DWARF as
emitted by gcc/clang at -g.

Parsed sections: .debug_abbrev (abbreviation tables), .debug_info (DIE
trees), .debug_str/.debug_line_str (string pools), .debug_str_offsets +
.debug_addr (v5 indexed forms). Indexed DIEs: subprograms (name,
low_pc, formal parameters with frame offsets from simple
DW_OP_fbreg/DW_OP_call_frame_cfa locations), base/pointer/typedef/
const/volatile type chains, and structure types with member offsets.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from .elf import ELFError, _EHDR, _SHDR

# DWARF tags (spec §7.5.1).
TAG_compile_unit = 0x11
TAG_subprogram = 0x2E
TAG_formal_parameter = 0x05
TAG_base_type = 0x24
TAG_pointer_type = 0x0F
TAG_typedef = 0x16
TAG_const_type = 0x26
TAG_volatile_type = 0x35
TAG_structure_type = 0x13
TAG_class_type = 0x02
TAG_member = 0x0D

# Attributes.
AT_name = 0x03
AT_byte_size = 0x0B
AT_low_pc = 0x11
AT_type = 0x49
AT_data_member_location = 0x38
AT_location = 0x02
AT_linkage_name = 0x6E
AT_specification = 0x47
AT_str_offsets_base = 0x72
AT_addr_base = 0x73

DW_OP_fbreg = 0x91


class DwarfError(ELFError):
    pass


@dataclass(frozen=True)
class ArgInfo:
    """One formal parameter (dwarf_reader.h ArgInfo analog)."""

    name: str
    type_name: str
    byte_size: int
    #: Frame-base-relative offset from a simple DW_OP_fbreg location
    #: (None when the location is register-allocated or complex).
    frame_offset: int | None = None


@dataclass(frozen=True)
class FunctionInfo:
    name: str
    low_pc: int
    args: tuple


@dataclass(frozen=True)
class MemberInfo:
    """Struct member (GetStructMemberInfo analog)."""

    name: str
    offset: int
    type_name: str
    byte_size: int


def _uleb(d: bytes, pos: int):
    v = shift = 0
    while True:
        b = d[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return v, pos


def _sleb(d: bytes, pos: int):
    v = shift = 0
    while True:
        b = d[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            if b & 0x40:
                v -= 1 << shift
            return v, pos


def _cstr(d: bytes, pos: int) -> tuple[str, int]:
    end = d.find(b"\0", pos)
    return d[pos:end].decode("utf-8", "replace"), end + 1


class _Sections:
    """ELF section extraction (shares the elf.py header structs)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            d = f.read()
        if len(d) < _EHDR.size or d[:4] != b"\x7fELF":
            raise DwarfError(f"{path}: not an ELF file")
        if d[4] != 2 or d[5] != 1:
            raise DwarfError(f"{path}: only 64-bit little-endian supported")
        (*_h, shoff, _flags, _ehsize, _phes, _phnum, shentsize, shnum,
         shstrndx) = _EHDR.unpack_from(d, 0)
        str_sh = _SHDR.unpack_from(d, shoff + shstrndx * shentsize)
        strtab_off = str_sh[4]
        self.sections: dict[str, bytes] = {}
        for i in range(shnum):
            (nm, _ty, _fl, _addr, off, size, _lnk, _inf, _al,
             _ent) = _SHDR.unpack_from(d, shoff + i * shentsize)
            name, _ = _cstr(d, strtab_off + nm)
            if name.startswith(".debug_"):
                self.sections[name] = d[off:off + size]


class _Abbrev:
    """One abbreviation table: code -> (tag, children, attr specs)."""

    def __init__(self, data: bytes, offset: int):
        self.entries: dict[int, tuple] = {}
        pos = offset
        while pos < len(data):
            code, pos = _uleb(data, pos)
            if code == 0:
                break
            tag, pos = _uleb(data, pos)
            children = data[pos]
            pos += 1
            specs = []
            while True:
                attr, pos = _uleb(data, pos)
                form, pos = _uleb(data, pos)
                iconst = None
                if form == 0x21:  # implicit_const
                    iconst, pos = _sleb(data, pos)
                if attr == 0 and form == 0:
                    break
                specs.append((attr, form, iconst))
            self.entries[code] = (tag, bool(children), tuple(specs))


class DwarfReader:
    """Indexes subprograms, types and structs from .debug_info.

    API mirror of the reference DwarfReader: ``get_function_arg_info``,
    ``get_struct_member_info``, ``get_struct_spec``, plus the function
    index itself (``functions``).
    """

    def __init__(self, path: str):
        s = _Sections(path)
        self._info = s.sections.get(".debug_info", b"")
        self._abbrev_data = s.sections.get(".debug_abbrev", b"")
        self._str = s.sections.get(".debug_str", b"")
        self._line_str = s.sections.get(".debug_line_str", b"")
        self._str_offsets = s.sections.get(".debug_str_offsets", b"")
        self._addr = s.sections.get(".debug_addr", b"")
        if not self._info or not self._abbrev_data:
            raise DwarfError(f"{path}: no DWARF debug info (compile with -g)")
        self.functions: dict[str, FunctionInfo] = {}
        self.structs: dict[str, tuple] = {}  # name -> tuple[MemberInfo]
        self._types: dict[int, tuple] = {}  # DIE offset -> (kind, payload)
        # Type refs may point FORWARD in the DIE stream; function/struct
        # payloads collect raw attrs during the walk and resolve here
        # once every type DIE is indexed.
        self._pending_fns: list = []
        self._pending_structs: list = []
        self._parse_all()
        for payload in self._pending_fns:
            self._finish_fn(payload)
        for payload in self._pending_structs:
            self._finish_struct(payload)
        del self._pending_fns, self._pending_structs

    # -- parsing -------------------------------------------------------------
    def _parse_all(self):
        pos = 0
        while pos + 11 <= len(self._info):
            pos = self._parse_cu(pos)

    def _parse_cu(self, cu_off: int) -> int:
        d = self._info
        (unit_len,) = struct.unpack_from("<I", d, cu_off)
        if unit_len in (0, 0xFFFFFFFF):
            return len(d)  # 64-bit DWARF / padding: stop
        end = cu_off + 4 + unit_len
        (version,) = struct.unpack_from("<H", d, cu_off + 4)
        if version == 5:
            unit_type = d[cu_off + 6]
            addr_size = d[cu_off + 7]
            (abbrev_off,) = struct.unpack_from("<I", d, cu_off + 8)
            pos = cu_off + 12
            if unit_type not in (1, 3):  # compile/partial units only
                return end
        elif version == 4 or version == 3 or version == 2:
            (abbrev_off,) = struct.unpack_from("<I", d, cu_off + 6)
            addr_size = d[cu_off + 10]
            pos = cu_off + 11
        else:
            return end
        abbrev = _Abbrev(self._abbrev_data, abbrev_off)
        # v5 indexed-form bases (defaults per spec: header-sized offsets).
        ctx = {
            "version": version, "addr_size": addr_size, "cu_off": cu_off,
            "str_offsets_base": 8, "addr_base": 8,
        }
        stack: list = []  # parent DIE frames: (tag, payload)
        pending_fn: list = []  # subprogram frames awaiting pop
        while pos < end:
            die_off = pos
            code, pos = _uleb(d, pos)
            if code == 0:
                if stack:
                    tag, payload = stack.pop()
                    if tag == TAG_subprogram and payload is not None:
                        self._pending_fns.append(payload)
                    elif (tag in (TAG_structure_type, TAG_class_type)
                          and payload is not None):
                        self._pending_structs.append(payload)
                continue
            entry = abbrev.entries.get(code)
            if entry is None:
                break  # malformed: abandon this CU
            tag, children, specs = entry
            attrs = {}
            for attr, form, iconst in specs:
                val, pos = self._read_form(d, pos, form, iconst, ctx)
                if attr in (AT_name, AT_byte_size, AT_low_pc, AT_type,
                            AT_data_member_location, AT_location,
                            AT_linkage_name, AT_specification,
                            AT_str_offsets_base, AT_addr_base):
                    attrs[attr] = val
            if tag == TAG_compile_unit:
                if AT_str_offsets_base in attrs:
                    ctx["str_offsets_base"] = attrs[AT_str_offsets_base]
                if AT_addr_base in attrs:
                    ctx["addr_base"] = attrs[AT_addr_base]
            self._index_die(die_off, tag, attrs, ctx, stack)
            if children:
                payload = None
                if tag == TAG_subprogram:
                    payload = {"attrs": attrs, "ctx": ctx, "params": []}
                elif tag in (TAG_structure_type, TAG_class_type):
                    payload = {"attrs": attrs, "ctx": ctx, "members": [],
                               "off": die_off}
                stack.append((tag, payload))
            elif tag == TAG_subprogram:
                self._pending_fns.append(
                    {"attrs": attrs, "ctx": ctx, "params": []}
                )
        return end

    def _index_die(self, off, tag, attrs, ctx, stack):
        if tag == TAG_base_type:
            self._types[off] = ("base", attrs.get(AT_name),
                                attrs.get(AT_byte_size, 0))
        elif tag == TAG_pointer_type:
            self._types[off] = ("ptr", attrs.get(AT_type), 8)
        elif tag in (TAG_typedef, TAG_const_type, TAG_volatile_type):
            self._types[off] = ("alias", attrs.get(AT_type),
                                attrs.get(AT_name))
        elif tag in (TAG_structure_type, TAG_class_type):
            self._types[off] = ("struct", attrs.get(AT_name),
                                attrs.get(AT_byte_size, 0))
        elif tag == TAG_formal_parameter and stack:
            for ptag, payload in reversed(stack):
                if ptag == TAG_subprogram and payload is not None:
                    payload["params"].append(attrs)
                    break
        elif tag == TAG_member and stack:
            ptag, payload = stack[-1]
            if ptag in (TAG_structure_type, TAG_class_type) and payload:
                payload["members"].append(attrs)

    def _finish_fn(self, payload):
        attrs = payload["attrs"]
        name = attrs.get(AT_name) or attrs.get(AT_linkage_name)
        if not name or AT_low_pc not in attrs:
            return
        args = []
        for p in payload["params"]:
            tname, tsize = self._resolve_type(p.get(AT_type))
            args.append(ArgInfo(
                name=p.get(AT_name) or f"arg{len(args)}",
                type_name=tname, byte_size=tsize,
                frame_offset=_fbreg_offset(p.get(AT_location)),
            ))
        self.functions[name] = FunctionInfo(
            name=name, low_pc=int(attrs[AT_low_pc] or 0), args=tuple(args)
        )

    def _finish_struct(self, payload):
        attrs = payload["attrs"]
        name = attrs.get(AT_name)
        if not name:
            return
        members = []
        for m in payload["members"]:
            tname, tsize = self._resolve_type(m.get(AT_type))
            off = m.get(AT_data_member_location)
            members.append(MemberInfo(
                name=m.get(AT_name) or "", offset=int(off or 0),
                type_name=tname, byte_size=tsize,
            ))
        self.structs[name] = tuple(members)

    def _resolve_type(self, ref, depth: int = 0) -> tuple[str, int]:
        """Follow a DW_AT_type reference chain to (type name, size)."""
        if ref is None or depth > 16:
            return ("void", 0)
        t = self._types.get(ref)
        if t is None:
            return ("?", 0)
        kind = t[0]
        if kind == "base":
            return (t[1] or "?", int(t[2] or 0))
        if kind == "ptr":
            inner, _sz = self._resolve_type(t[1], depth + 1)
            return (inner + "*", 8)
        if kind == "alias":
            inner, sz = self._resolve_type(t[1], depth + 1)
            return (t[2] or inner, sz)
        if kind == "struct":
            return ("struct " + (t[1] or "?"), int(t[2] or 0))
        return ("?", 0)

    # -- form decoding --------------------------------------------------------
    def _read_form(self, d, pos, form, iconst, ctx):
        asz = ctx["addr_size"]
        if form == 0x01:  # addr
            v = int.from_bytes(d[pos:pos + asz], "little")
            return v, pos + asz
        if form in (0x0B, 0x21):  # data1 / implicit_const
            if form == 0x21:
                return iconst, pos
            return d[pos], pos + 1
        if form == 0x05:
            return int.from_bytes(d[pos:pos + 2], "little"), pos + 2
        if form == 0x06:
            return int.from_bytes(d[pos:pos + 4], "little"), pos + 4
        if form == 0x07:
            return int.from_bytes(d[pos:pos + 8], "little"), pos + 8
        if form == 0x0D:
            return _sleb(d, pos)
        if form == 0x0F:
            return _uleb(d, pos)
        if form == 0x08:  # string (inline)
            return _cstr(d, pos)
        if form == 0x0E:  # strp
            (off,) = struct.unpack_from("<I", d, pos)
            return _cstr(self._str, off)[0], pos + 4
        if form == 0x1F:  # line_strp
            (off,) = struct.unpack_from("<I", d, pos)
            return _cstr(self._line_str, off)[0], pos + 4
        if form == 0x11:  # ref1
            return ctx["cu_off"] + d[pos], pos + 1
        if form == 0x12:
            return ctx["cu_off"] + int.from_bytes(d[pos:pos + 2], "little"), pos + 2
        if form == 0x13:  # ref4
            return ctx["cu_off"] + int.from_bytes(d[pos:pos + 4], "little"), pos + 4
        if form == 0x14:  # ref8
            return ctx["cu_off"] + int.from_bytes(d[pos:pos + 8], "little"), pos + 8
        if form == 0x15:  # ref_udata
            v, pos = _uleb(d, pos)
            return ctx["cu_off"] + v, pos
        if form == 0x10:  # ref_addr (section-relative, already absolute)
            return int.from_bytes(d[pos:pos + 4], "little"), pos + 4
        if form == 0x17:  # sec_offset
            return int.from_bytes(d[pos:pos + 4], "little"), pos + 4
        if form == 0x18:  # exprloc
            n, pos = _uleb(d, pos)
            return d[pos:pos + n], pos + n
        if form == 0x0C:  # flag
            return bool(d[pos]), pos + 1
        if form == 0x19:  # flag_present
            return True, pos
        if form in (0x1A, 0x25, 0x26, 0x27, 0x28):  # strx*
            if form == 0x1A:
                idx, pos = _uleb(d, pos)
            else:
                n = form - 0x24
                idx = int.from_bytes(d[pos:pos + n], "little")
                pos += n
            base = ctx["str_offsets_base"]
            so = base + idx * 4
            if so + 4 <= len(self._str_offsets):
                (off,) = struct.unpack_from("<I", self._str_offsets, so)
                return _cstr(self._str, off)[0], pos
            return "", pos
        if form in (0x1B, 0x29, 0x2A, 0x2B, 0x2C):  # addrx*
            if form == 0x1B:
                idx, pos = _uleb(d, pos)
            else:
                n = form - 0x28
                idx = int.from_bytes(d[pos:pos + n], "little")
                pos += n
            base = ctx["addr_base"]
            ao = base + idx * asz
            if ao + asz <= len(self._addr):
                return int.from_bytes(self._addr[ao:ao + asz], "little"), pos
            return 0, pos
        if form in (0x22, 0x23):  # loclistx / rnglistx
            return _uleb(d, pos)
        if form == 0x0A:  # block1
            n = d[pos]
            return d[pos + 1:pos + 1 + n], pos + 1 + n
        if form == 0x03:  # block2
            n = int.from_bytes(d[pos:pos + 2], "little")
            return d[pos + 2:pos + 2 + n], pos + 2 + n
        if form == 0x04:  # block4
            n = int.from_bytes(d[pos:pos + 4], "little")
            return d[pos + 4:pos + 4 + n], pos + 4 + n
        if form == 0x09:  # block
            n, pos = _uleb(d, pos)
            return d[pos:pos + n], pos + n
        if form == 0x1E:  # data16
            return d[pos:pos + 16], pos + 16
        if form == 0x20:  # ref_sig8
            return int.from_bytes(d[pos:pos + 8], "little"), pos + 8
        raise DwarfError(f"unsupported DWARF form {form:#x}")

    # -- reference-API surface ------------------------------------------------
    def get_function_arg_info(self, name: str) -> tuple:
        """ArgInfo tuple for a function (dwarf_reader.h GetFunctionArgInfo)."""
        fn = self.functions.get(name)
        if fn is None:
            raise KeyError(f"no DWARF subprogram named {name!r}")
        return fn.args

    def get_struct_member_info(self, struct_name: str, member: str) -> MemberInfo:
        for m in self.structs.get(struct_name, ()):
            if m.name == member:
                return m
        raise KeyError(f"no member {member!r} in struct {struct_name!r}")

    def get_struct_spec(self, struct_name: str) -> tuple:
        """Flat member layout (GetStructSpec analog)."""
        if struct_name not in self.structs:
            raise KeyError(f"no struct named {struct_name!r}")
        return self.structs[struct_name]


def _fbreg_offset(loc) -> int | None:
    """Frame offset from a simple DW_OP_fbreg exprloc, else None."""
    if not isinstance(loc, (bytes, bytearray)) or not loc:
        return None
    if loc[0] != DW_OP_fbreg:
        return None
    off, _ = _sleb(bytes(loc), 1)
    return off
