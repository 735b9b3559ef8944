"""Compression level / option presets.

Field-for-field mirror of ``deflate_rs_tpu/compression_options.py`` (the
reference's configuration surface, compression_options.rs:31-196), with the
same presets, resolved properties and ``cache_key()``.  The JAX package's
kernel gates (``lr_kernel``, ``hist_kernel``, ``field_kernel``) are left out:
on a CUDA tensor the port's kernels always run, and on a CPU tensor their
plain PyTorch versions do.  Every option the JAX package accepts runs,
the long-range knobs ``lr_global`` and ``lr_stride`` included.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

HIGH_MAX_HASH_CHECKS = 1768
HIGH_LAZY_IF_LESS_THAN = 128
MAX_HASH_CHECKS = 32 * 1024
DEFAULT_MAX_HASH_CHECKS = 128
DEFAULT_LAZY_IF_LESS_THAN = 32

# Static cap on the vectorized candidate width (as in the JAX package).
KERNEL_MAX_CANDIDATES = 256


class MatchingType(enum.Enum):
    """Whether to use lazy or greedy matching (lz77.rs:27)."""

    Greedy = "greedy"
    Lazy = "lazy"


class SpecialOptions(enum.Enum):
    """Special compression strategies (compression_options.rs:52-59)."""

    Normal = "normal"
    ForceFixed = "force_fixed"
    ForceStored = "force_stored"


class Compression(enum.Enum):
    """Simplified compression level selector (compression_options.rs:31-42)."""

    Fast = "fast"
    Default = "default"
    Best = "best"


@dataclass(frozen=True)
class CompressionOptions:
    """Tunable compression settings (compression_options.rs:78-120).

    The internal knobs below ``special`` have the meaning documented on the
    JAX dataclass of the same name."""

    max_hash_checks: int = DEFAULT_MAX_HASH_CHECKS
    lazy_if_less_than: int = DEFAULT_LAZY_IF_LESS_THAN
    matching_type: MatchingType = MatchingType.Lazy
    special: SpecialOptions = SpecialOptions.Normal
    chain_scale: int = 1
    split_scoring: str = "auto"
    sort_nkey: int = 0
    block_split: str = "auto"
    long_range: str = "auto"
    probe_words_override: int = 0
    num_dom: int = 0
    dom_segs: int = 0
    dom_iters: int = 0
    lr_global: int = 0
    lr_stride: int = 0
    lr_sel: str = "auto"
    sa_tail: str = "auto"

    @staticmethod
    def default() -> "CompressionOptions":
        return CompressionOptions()

    @staticmethod
    def high() -> "CompressionOptions":
        """Roughly the HIGH(9) setting in miniz (compression_options.rs:126-133)."""
        return CompressionOptions(
            max_hash_checks=HIGH_MAX_HASH_CHECKS,
            lazy_if_less_than=HIGH_LAZY_IF_LESS_THAN,
            matching_type=MatchingType.Lazy,
        )

    @staticmethod
    def fast() -> "CompressionOptions":
        """Fast settings (compression_options.rs:141-148)."""
        return CompressionOptions(
            max_hash_checks=1, lazy_if_less_than=0, matching_type=MatchingType.Greedy
        )

    @staticmethod
    def huffman_only() -> "CompressionOptions":
        """Huffman-coding only, no match search (compression_options.rs:155-162)."""
        return CompressionOptions(
            max_hash_checks=0, lazy_if_less_than=0, matching_type=MatchingType.Greedy
        )

    @staticmethod
    def turbo() -> "CompressionOptions":
        """One entropy-proxy-scored dynamic block per chunk, no match search."""
        return CompressionOptions(
            max_hash_checks=0, lazy_if_less_than=0,
            matching_type=MatchingType.Greedy, split_scoring="proxy",
            block_split="1",
        )

    @staticmethod
    def rle() -> "CompressionOptions":
        """Run-length (distance 1) matching only (compression_options.rs:171-178)."""
        return CompressionOptions(
            max_hash_checks=0, lazy_if_less_than=0, matching_type=MatchingType.Lazy
        )

    @staticmethod
    def from_compression(level: "Compression") -> "CompressionOptions":
        return {
            Compression.Fast: CompressionOptions.fast(),
            Compression.Default: CompressionOptions.default(),
            Compression.Best: CompressionOptions.high(),
        }[level]

    # --- static kernel configuration (same rules as the JAX package) -----

    @property
    def matcher_mode(self) -> str:
        """'none' (huffman only), 'rle', or 'hash' — lz77.rs:192-232 dispatch."""
        if self.max_hash_checks == 0:
            return "rle" if self.matching_type == MatchingType.Lazy else "none"
        return "hash"

    @property
    def matcher_algo(self) -> str:
        """'sa' (bounded suffix sort) or 'hash' (hash sort + K-probe)."""
        return "hash" if self.max_hash_checks > 2 * KERNEL_MAX_CANDIDATES else "sa"

    @property
    def num_candidates(self) -> int:
        """Matcher scan depth from the reference's chain-walk budget."""
        if self.matcher_algo == "hash":
            return max(1, min(self.max_hash_checks, KERNEL_MAX_CANDIDATES))
        return max(
            1,
            min(self.max_hash_checks * self.chain_scale, KERNEL_MAX_CANDIDATES) // 2,
        )

    @property
    def probe_words(self) -> int:
        """Probe window width in 4-byte words."""
        if self.probe_words_override:
            if not 1 <= self.probe_words_override <= 18:
                raise ValueError(
                    f"probe_words_override={self.probe_words_override}: must "
                    "be in [1, 18] (probe reads are bounded by the chunk "
                    "buffer's 72-byte tail padding)"
                )
            return self.probe_words_override
        if self.fast_family:
            return 4
        base = 16 if self.max_hash_checks > DEFAULT_MAX_HASH_CHECKS else 6
        if base == 6 and self.chain_scale > 1:
            return 8
        return base

    @property
    def lazy(self) -> bool:
        return self.matching_type == MatchingType.Lazy and self.lazy_if_less_than > 0

    @property
    def exact_split_scoring(self) -> bool:
        """Exact package-merge scoring of split compositions (high,
        huffman_only, rle) or the entropy proxy (fast, default)."""
        if self.split_scoring != "auto":
            return self.split_scoring == "exact"
        throughput_preset = self.matcher_mode == "hash" and self.matcher_algo == "sa"
        return not throughput_preset

    @property
    def fast_family(self) -> bool:
        """Greedy presets with a tiny chain budget (compression_options.rs:141-148)."""
        return (
            self.matcher_mode == "hash"
            and self.matching_type == MatchingType.Greedy
            and self.max_hash_checks <= 4
        )

    @property
    def num_quarters(self) -> int:
        """Static sub-quarter count for intra-chunk block splitting."""
        if self.block_split not in ("auto", "on", "off"):
            nq = int(self.block_split)
            if nq < 1 or nq > 32 or (nq & (nq - 1)) != 0:
                raise ValueError(
                    f"block_split={self.block_split!r}: numeric override "
                    "must be a power of two in [1, 32]"
                )
            return nq
        if self.block_split != "auto":
            return 4 if self.block_split == "on" else 1
        if self.fast_family:
            return 1
        return 8 if self.matcher_mode == "hash" else 4

    @property
    def use_long_range(self) -> bool:
        if self.long_range != "auto":
            return self.long_range == "on"
        return self.matcher_mode == "hash" and not self.fast_family

    @property
    def resolved_sa_tail(self) -> tuple:
        if self.sa_tail == "off":
            return ()
        if self.sa_tail != "auto":
            return tuple(int(x) for x in self.sa_tail.split(","))
        if self.fast_family or self.matcher_algo != "sa":
            return ()
        return (4, 5, 6, 7, 8, 9, 10, 11)

    @property
    def resolved_num_dom(self) -> int:
        return self.num_dom if self.num_dom else 48

    @property
    def resolved_dom_segs(self) -> int:
        if self.dom_segs:
            return self.dom_segs
        return 32 if self.matcher_algo == "hash" else 64

    @property
    def resolved_dom_iters(self) -> int:
        if self.dom_iters:
            return self.dom_iters
        return 2 if self.matcher_algo == "hash" else 1

    @property
    def resolved_lr_stride(self) -> int:
        return self.lr_stride if self.lr_stride else 1

    @property
    def resolved_lr_sel(self) -> str:
        if self.lr_sel != "auto":
            return self.lr_sel
        return "freq" if self.matcher_algo == "hash" else "run"

    @property
    def resolved_lr_pair(self) -> bool:
        return self.resolved_lr_stride == 1

    @property
    def resolved_sort_nkey(self) -> int:
        if self.sort_nkey:
            return self.sort_nkey
        return 1 if self.fast_family else min(4, self.probe_words)

    def cache_key(self) -> tuple:
        """The JAX package's cache key without its trailing kernel-gate tuple."""
        return (
            self.matcher_mode,
            self.matcher_algo,
            self.num_candidates,
            self.probe_words,
            self.resolved_sort_nkey,
            self.lazy,
            min(self.lazy_if_less_than, 258),
            self.special.value,
            self.exact_split_scoring,
            self.num_quarters,
            self.use_long_range,
            (self.resolved_num_dom, self.resolved_dom_segs,
             self.resolved_dom_iters, self.lr_global, self.resolved_lr_stride,
             self.resolved_lr_sel, self.resolved_lr_pair)
            if self.use_long_range else (0, 0, 0, 0, 0, "", False),
            self.resolved_sa_tail,
        )


_KERNEL_GATES = ("lr_kernel", "hist_kernel", "field_kernel")


def options_from_reference(fields: dict) -> CompressionOptions:
    """The port's options from the JAX options' ``dataclasses.asdict``.

    Enum members (of either package) are mapped by value; the JAX kernel
    gates are dropped."""
    kw = {k: v for k, v in fields.items() if k not in _KERNEL_GATES}
    for name, cls in (("matching_type", MatchingType), ("special", SpecialOptions)):
        if name in kw:
            kw[name] = cls(getattr(kw[name], "value", kw[name]))
    return CompressionOptions(**kw)

