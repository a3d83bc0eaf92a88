"""Zero-copy Solana transaction parser (legacy and v0 with address
lookups), the counterpart of ``firedancer_tpu/ballet/txn.py``
(``parse_txn``:167, ``TxnParseError``:53, ``MAX_SIG_CNT``:37,
``verify_items``:158, ``build_txn``:277).

The wire format (Solana protocol, public spec):
    compact-u16 signature_cnt, then 64-byte signatures
    message:
      [v0 only] prefix byte 0x80 | version
      3-byte header: num_required_signatures, num_readonly_signed,
                     num_readonly_unsigned
      compact-u16 account_cnt, then 32-byte account keys
      32-byte recent blockhash
      compact-u16 instr_cnt, then per instruction:
          u8 program_id_index
          compact-u16 acct_cnt + that many u8 account indices
          compact-u16 data_sz + data bytes
      [v0 only] compact-u16 addr_lut_cnt, then per lookup table:
          32-byte table account key
          compact-u16 writable_cnt + u8 indices
          compact-u16 readonly_cnt + u8 indices

The descriptor stores offsets and counts into the original buffer, so
the verify tile slices (signature_i, account_i, message) views without
copies. The limits derive from the 1232-byte MTU (fd_txn.h:56-83). The
native drain (``native/verify_drain.cc``) parses with the same rules.
``build_txn`` takes the signers' public keys from its caller.
"""

from __future__ import annotations

from dataclasses import dataclass, field

MTU = 1232                      # FD_TPU_MTU (fd_quic.h:46)
MAX_SIG_CNT = 19                # (1232 - 3 - 32) / 64 rounded; wire max fits
MAX_ACCT_CNT = 35               # MTU-derived ceiling like fd_txn.h:64
MAX_INSTR_CNT = 355             # fd_txn.h-style MTU bound

# Parse error codes (negative, 0 = success), own numbering.
ERR_TRUNCATED = -1
ERR_SIG_CNT = -2
ERR_HEADER = -3
ERR_ACCT_CNT = -4
ERR_INSTR = -5
ERR_VERSION = -6
ERR_LUT = -7
ERR_TRAILING = -8
ERR_CU16 = -9


class TxnParseError(ValueError):
    def __init__(self, code: int, why: str):
        super().__init__(f"txn parse error {code}: {why}")
        self.code = code


def read_compact_u16(buf: bytes, off: int) -> tuple[int, int]:
    """Decode a compact-u16 varint at off. Returns (value, new_off).

    1-3 bytes, 7 bits per byte, little-endian groups; the canonical form
    used by Solana short-vec lengths (reference fd_compact_u16.h).
    """
    if off >= len(buf):
        raise TxnParseError(ERR_CU16, "compact-u16 past end")
    b0 = buf[off]
    if b0 < 0x80:
        return b0, off + 1
    if off + 1 >= len(buf):
        raise TxnParseError(ERR_CU16, "compact-u16 truncated")
    b1 = buf[off + 1]
    if b1 < 0x80:
        val = (b0 & 0x7F) | (b1 << 7)
        if b1 == 0:
            raise TxnParseError(ERR_CU16, "non-minimal compact-u16")
        return val, off + 2
    if off + 2 >= len(buf):
        raise TxnParseError(ERR_CU16, "compact-u16 truncated")
    b2 = buf[off + 2]
    if b2 > 0x03:
        raise TxnParseError(ERR_CU16, "compact-u16 overflow")
    val = (b0 & 0x7F) | ((b1 & 0x7F) << 7) | (b2 << 14)
    if b2 == 0:
        raise TxnParseError(ERR_CU16, "non-minimal compact-u16")
    return val, off + 3


def write_compact_u16(val: int) -> bytes:
    if val < 0 or val > 0xFFFF:
        raise ValueError("compact-u16 range")
    out = bytearray()
    while True:
        b = val & 0x7F
        val >>= 7
        if val:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


@dataclass
class Instr:
    program_id_index: int
    acct_off: int          # offset of the u8 index array
    acct_cnt: int
    data_off: int
    data_sz: int


@dataclass
class AddrLut:
    table_key_off: int     # offset of the 32-byte table address
    writable_off: int
    writable_cnt: int
    readonly_off: int
    readonly_cnt: int


@dataclass
class TxnDescriptor:
    """Offset-based view of one transaction (zero-copy)."""

    version: int                  # -1 = legacy, 0 = v0
    signature_cnt: int
    signature_off: int            # 64*i strided
    message_off: int              # start of signed payload
    num_required_signatures: int
    num_readonly_signed: int
    num_readonly_unsigned: int
    acct_cnt: int
    acct_off: int                 # 32*i strided
    recent_blockhash_off: int
    instrs: list[Instr] = field(default_factory=list)
    addr_luts: list[AddrLut] = field(default_factory=list)
    total_sz: int = 0

    def signature(self, buf: bytes, i: int) -> bytes:
        o = self.signature_off + 64 * i
        return buf[o : o + 64]

    def account(self, buf: bytes, i: int) -> bytes:
        o = self.acct_off + 32 * i
        return buf[o : o + 32]

    def message(self, buf: bytes) -> bytes:
        return buf[self.message_off : self.total_sz]

    def is_writable(self, i: int) -> bool:
        """Static account write-lock classification (Solana rules)."""
        n_req = self.num_required_signatures
        if i < n_req:
            return i < n_req - self.num_readonly_signed
        n_static = self.acct_cnt
        return i < n_static - self.num_readonly_unsigned

    def verify_items(self, buf: bytes):
        """(signature, pubkey, message) triples for sigverify."""
        msg = self.message(buf)
        return [
            (self.signature(buf, i), self.account(buf, i), msg)
            for i in range(self.signature_cnt)
        ]


def parse_txn(buf: bytes) -> TxnDescriptor:
    """Parse one transaction. Raises TxnParseError on malformed input."""
    if len(buf) > MTU:
        raise TxnParseError(ERR_TRUNCATED, f"larger than MTU {MTU}")
    sig_cnt, off = read_compact_u16(buf, 0)
    if sig_cnt == 0 or sig_cnt > MAX_SIG_CNT:
        raise TxnParseError(ERR_SIG_CNT, f"signature_cnt {sig_cnt}")
    sig_off = off
    off += 64 * sig_cnt
    if off > len(buf):
        raise TxnParseError(ERR_TRUNCATED, "signatures past end")

    message_off = off
    version = -1
    if off < len(buf) and buf[off] & 0x80:
        version = buf[off] & 0x7F
        if version != 0:
            raise TxnParseError(ERR_VERSION, f"unsupported version {version}")
        off += 1

    if off + 3 > len(buf):
        raise TxnParseError(ERR_TRUNCATED, "header past end")
    n_req, n_ro_signed, n_ro_unsigned = buf[off], buf[off + 1], buf[off + 2]
    off += 3
    if n_req != sig_cnt:
        raise TxnParseError(ERR_HEADER, "num_required != signature_cnt")
    if n_ro_signed >= max(n_req, 1):
        raise TxnParseError(ERR_HEADER, "readonly_signed >= required")

    acct_cnt, off = read_compact_u16(buf, off)
    if acct_cnt < n_req or acct_cnt > MAX_ACCT_CNT:
        raise TxnParseError(ERR_ACCT_CNT, f"acct_cnt {acct_cnt}")
    if n_ro_unsigned > acct_cnt - n_req:
        raise TxnParseError(ERR_HEADER, "readonly_unsigned too large")
    acct_off = off
    off += 32 * acct_cnt
    if off > len(buf):
        raise TxnParseError(ERR_TRUNCATED, "accounts past end")

    blockhash_off = off
    off += 32
    if off > len(buf):
        raise TxnParseError(ERR_TRUNCATED, "blockhash past end")

    instr_cnt, off = read_compact_u16(buf, off)
    if instr_cnt > MAX_INSTR_CNT:
        raise TxnParseError(ERR_INSTR, f"instr_cnt {instr_cnt}")
    instrs = []
    for _ in range(instr_cnt):
        if off >= len(buf):
            raise TxnParseError(ERR_TRUNCATED, "instr past end")
        prog_idx = buf[off]
        off += 1
        if prog_idx >= acct_cnt:
            raise TxnParseError(ERR_INSTR, "program index out of range")
        a_cnt, off = read_compact_u16(buf, off)
        a_off = off
        off += a_cnt
        if off > len(buf):
            raise TxnParseError(ERR_TRUNCATED, "instr accounts past end")
        for k in range(a_cnt):
            if buf[a_off + k] >= acct_cnt and version == -1:
                raise TxnParseError(ERR_INSTR, "acct index out of range")
        d_sz, off = read_compact_u16(buf, off)
        d_off = off
        off += d_sz
        if off > len(buf):
            raise TxnParseError(ERR_TRUNCATED, "instr data past end")
        instrs.append(Instr(prog_idx, a_off, a_cnt, d_off, d_sz))

    addr_luts = []
    if version == 0:
        lut_cnt, off = read_compact_u16(buf, off)
        for _ in range(lut_cnt):
            key_off = off
            off += 32
            if off > len(buf):
                raise TxnParseError(ERR_TRUNCATED, "lut key past end")
            w_cnt, off = read_compact_u16(buf, off)
            w_off = off
            off += w_cnt
            if off > len(buf):
                raise TxnParseError(ERR_TRUNCATED, "lut writable past end")
            r_cnt, off = read_compact_u16(buf, off)
            r_off = off
            off += r_cnt
            if off > len(buf):
                raise TxnParseError(ERR_TRUNCATED, "lut readonly past end")
            addr_luts.append(AddrLut(key_off, w_off, w_cnt, r_off, r_cnt))

    if off != len(buf):
        raise TxnParseError(ERR_TRAILING, f"{len(buf) - off} trailing bytes")

    return TxnDescriptor(
        version=version,
        signature_cnt=sig_cnt,
        signature_off=sig_off,
        message_off=message_off,
        num_required_signatures=n_req,
        num_readonly_signed=n_ro_signed,
        num_readonly_unsigned=n_ro_unsigned,
        acct_cnt=acct_cnt,
        acct_off=acct_off,
        recent_blockhash_off=blockhash_off,
        instrs=instrs,
        addr_luts=addr_luts,
        total_sz=len(buf),
    )


def build_txn(
    *,
    signer_seeds: list[bytes],
    pubs: list[bytes],
    sign_fn,
    extra_accounts: list[bytes] = (),
    n_readonly_signed: int = 0,
    n_readonly_unsigned: int = 0,
    recent_blockhash: bytes = b"\x01" * 32,
    instrs: list[tuple[int, list[int], bytes]] = (),
    version: int = -1,
    addr_luts: list[tuple[bytes, list[int], list[int]]] = (),
) -> bytes:
    """Construct a wire transaction (test fixtures, synthetic load).

    signer_seeds: ed25519 seeds; pubs: their public keys, account i =
    pubs[i]. instrs: (program_id_index, account_indices, data).
    sign_fn(msg, seed) -> 64-byte signature.
    """
    if len(pubs) != len(signer_seeds):
        raise ValueError("one public key per signer seed")
    accounts = list(pubs) + list(extra_accounts)
    msg = bytearray()
    if version >= 0:
        msg.append(0x80 | version)
    msg += bytes([len(signer_seeds), n_readonly_signed, n_readonly_unsigned])
    msg += write_compact_u16(len(accounts))
    for a in accounts:
        msg += a
    msg += recent_blockhash
    msg += write_compact_u16(len(instrs))
    for prog_idx, accs, data in instrs:
        msg.append(prog_idx)
        msg += write_compact_u16(len(accs))
        msg += bytes(accs)
        msg += write_compact_u16(len(data))
        msg += data
    if version >= 0:
        msg += write_compact_u16(len(addr_luts))
        for key, wr, ro in addr_luts:
            msg += key
            msg += write_compact_u16(len(wr))
            msg += bytes(wr)
            msg += write_compact_u16(len(ro))
            msg += bytes(ro)

    out = bytearray()
    out += write_compact_u16(len(signer_seeds))
    for s in signer_seeds:
        out += sign_fn(bytes(msg), s)
    out += msg
    return bytes(out)
