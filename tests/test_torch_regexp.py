"""The regexp functions in the port (``ops/regex_engine.py``,
``sql/expressions/regexp.py``, the DFA kernels' plain versions in
``ops/kernels.py``), held against the JAX package on the CPU: the compiled
DFA tables equal, the DFA walks (``dfa_search_plain``,
``dfa_match_spans_plain``) equal to the JAX module's numpy backend over
numpy-seeded strings, and the expressions through both packages' DataFrame
and SQL APIs.  The cases mirror the reference's ``tests/test_regexp.py``
(its JSON tests aside); Python's ``re`` is the oracle where both agree with
Java.

Where the JAX package runs Python's ``re`` on its host (capture groups
beyond the whole match, ``$n`` references, a split pattern that can match
the empty string, a pattern its DFA compiler rejects), the port raises
NotImplementedError naming the construct.  Held to Spark where the JAX
package differs: ``split(s, ',', 0)`` keeps trailing empty parts (Spark 3
reads limit 0 as -1; the JAX package drops them as Java's String.split
does)."""

import re as pyre

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu as jsrt
from spark_rapids_tpu.ops import regex_engine as JRX
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.session import TpuSession
import spark_rapids_tpu_torch as srt
from spark_rapids_tpu_torch.ops import kernels as K
from spark_rapids_tpu_torch.ops import regex_engine as RX
from spark_rapids_tpu_torch.sql import functions as F


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    TpuSession._active = None
    yield
    torch.set_num_threads(threads)
    TpuSession._active = None


STRS = ["hello world", "abc123def", "", "aaa", "2021-03-04",
        "foo@bar.com", "x,y,,z", "   spaces   ", "MixedCASE99",
        "tab\there", "dot.dot.dot", "a1b2c3d4"]


@pytest.fixture(scope="module")
def table():
    return pa.table({"u": list(range(len(STRS))), "s": STRS})


@pytest.fixture(scope="module")
def port(table):
    sess = srt.session(device="cpu")
    sess.create_dataframe(table).createOrReplaceTempView("t")
    return sess


@pytest.fixture(scope="module")
def ref(table):
    sess = jsrt.session()
    sess.create_dataframe(table).createOrReplaceTempView("t")
    return sess


def port_rows(port, table, cols):
    df = port.create_dataframe(table)
    return df.select(df.u, *cols(df, F)).collect().to_pylist()


def ref_rows(ref, table, cols):
    df = ref.create_dataframe(table)
    return df.select(df.u, *cols(df, JF)).collect().to_pylist()


def recording(name):
    """Count the calls of ``K.<name>`` (on the CPU the wrappers launch
    nothing: this shows the expression went through them)."""
    calls = []
    fn = getattr(K, name)

    def rec(*args):
        calls.append(args)
        return fn(*args)
    return calls, rec


# --------------------------------------------------------------------------
# the compiler and the walks against the JAX module
# --------------------------------------------------------------------------

PATTERNS = [r"\d+", r"[a-c]+", r"^a", r"o$", r"world", r"(foo|dot)",
            r"a{2,3}", r"\w+@\w+\.\w+", r"\d{4}-\d{2}-\d{2}", r"\s+",
            r"[^,]+", r".", r"(?:ab)+c?", r"[A-Z][a-z]+", r"x*", r"^$",
            r"special.*requests", r"é+"]


@pytest.mark.parametrize("search", [True, False])
def test_compiled_tables_equal_the_reference(search):
    for pat in PATTERNS:
        a = RX.compile_regex(pat, search_prefix=search)
        b = JRX.compile_regex(pat, search_prefix=search)
        np.testing.assert_array_equal(a.table, b.table)
        np.testing.assert_array_equal(a.byte_class, b.byte_class)
        np.testing.assert_array_equal(a.accept, b.accept)
        assert (a.start, a.dead, a.anchored_start, a.anchored_end,
                a.ngroups, a.min_len) == (b.start, b.dead, b.anchored_start,
                                          b.anchored_end, b.ngroups,
                                          b.min_len), pat


def seeded_rows(n=300, width=32, seed=3):
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ab cd,x1234-@.o\x00", dtype=np.uint8)
    lens = rng.integers(0, width + 1, n).astype(np.int32)
    lens[:3] = [0, width, 1]
    chars = alphabet[rng.integers(0, alphabet.size, (n, width))]
    chars[np.arange(width)[None] >= lens[:, None]] = 0
    return chars, lens


@pytest.mark.parametrize("pat", PATTERNS + [r"ab$", r"^a.*4$", r"[^a]"])
def test_walks_equal_the_reference_numpy_backend(pat):
    chars, lens = seeded_rows()
    tc, tl = torch.from_numpy(chars), torch.from_numpy(lens)
    rx = RX.compile_regex(pat, search_prefix=True)
    jrx = JRX.compile_regex(pat, search_prefix=True)
    hit = K.dfa_search(K.dfa_tables(rx, "cpu"), tc, tl)
    np.testing.assert_array_equal(hit.numpy(),
                                  JRX.dfa_search(np, jrx, chars, lens))
    rx = RX.compile_regex(pat)
    jrx = JRX.compile_regex(pat)
    chosen, mlen = K.dfa_match_spans(K.dfa_tables(rx, "cpu"), tc, tl)
    jc, jm = JRX.dfa_match_spans(np, jrx, chars, lens)
    np.testing.assert_array_equal(chosen.numpy(), jc)
    np.testing.assert_array_equal(mlen.numpy(), jm)
    assert K.LAUNCHES["dfa_search"] == K.LAUNCHES["dfa_match_spans"] == 0


def fused_search(fused, start, accept_start, anchored_end, chars, lens):
    """The search kernel's walk (``csrc/regex_dfa.cu`` ``search_row``) over
    the fused table in numpy: each byte's entry is ``fused[(state << 8) |
    byte]`` (``next | accept[next] << 8``), its low byte the next state;
    the accept bits are OR-ed up, or, anchored at the end, the last entry's
    is taken (the start's for an empty row)."""
    fused = (fused.astype(np.int64) & 0xFFFF).ravel()
    rows, width = chars.shape
    e0 = start | (int(accept_start) << 8)
    e = np.full(rows, e0, dtype=np.int64)
    h = e.copy()
    for j in range(width):
        live = j < lens
        nxt = fused[((e & 0xFF) << 8) | chars[:, j]]
        e = np.where(live, nxt, e)
        if not anchored_end:
            h |= np.where(live, e, 0)
    return (((e if anchored_end else h) >> 8) & 1).astype(bool)


def synthetic_dfa(anchored_end, states=255, classes=200, seed=18):
    """A random table of ``states`` x ``classes`` whose last state is dead
    (it goes only to itself and accepts nothing, as the compiler's is), in
    the JAX module's form: chip_smoke.py's 255-state check table."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, states, (states, classes)).astype(np.int32)
    table[states - 1] = states - 1
    accept = rng.random(states) < 0.05
    accept[states - 1] = False
    return JRX.CompiledRegex(table, rng.integers(0, classes, 256).astype(
        np.int32), accept, 0, states - 1, False, anchored_end, 0)


@pytest.mark.parametrize("pat", PATTERNS + [r"ab$", r"^a.*4$", r"[^a]",
                                            "255 states", "255 states$"])
def test_fused_search_walk_equals_the_reference_numpy_backend(pat):
    """``dfa_fused``'s table walked as the search kernel walks it equals the
    JAX module's ``dfa_search`` (numpy backend): the patterns, those
    anchored at their end, and a synthetic table of 255 states and 200
    classes (128 KB of entries: the kernel's large shared-memory case).
    The rows: :func:`seeded_rows`, then :data:`STRS` and a few that the
    other patterns find."""
    chars, lens = seeded_rows()
    extra = [t.encode() for t in STRS + ["special requests", "café",
                                        "xab", "a 4"]]
    more = np.zeros((len(extra), chars.shape[1]), dtype=np.uint8)
    for i, t in enumerate(extra):
        more[i, :len(t)] = np.frombuffer(t, dtype=np.uint8)
    chars = np.concatenate([chars, more])
    lens = np.concatenate([lens, [len(t) for t in extra]]).astype(np.int32)
    if pat.startswith("255 states"):
        jrx = synthetic_dfa(pat.endswith("$"))
        rng = np.random.default_rng(7)
        chars = rng.integers(0, 256, chars.shape).astype(np.uint8)
        chars[np.arange(chars.shape[1])[None] >= lens[:, None]] = 0
        tables = {k: torch.from_numpy(v.astype(np.uint8)) for k, v in (
            ("table", jrx.table), ("cls", jrx.byte_class),
            ("accept", jrx.accept))}
        fused = K.dfa_fused(**tables)
    else:
        jrx = JRX.compile_regex(pat, search_prefix=True)
        dfa = K.dfa_tables(RX.compile_regex(pat, search_prefix=True), "cpu")
        fused = dfa["fused"]
        assert fused.dtype == torch.int16
        assert fused.shape == (dfa["states"], 256)
    got = fused_search(fused.numpy(), jrx.start, jrx.accept[jrx.start],
                       jrx.anchored_end, chars, lens)
    want = JRX.dfa_search(np, jrx, chars, lens)
    np.testing.assert_array_equal(got, want)
    assert want.any() or pat in (r"^$", "255 states$")


SPAN_PATTERNS = [r"[aeiou]+", r"^[0-9]+", r"[0-9]+$", r"x*", r"^$",
                 r"a.c", r" "]


@pytest.mark.parametrize("width", [1, 15, 16, 17, 33, 65, 200])
def test_spans_at_every_width_equal_the_reference(width):
    """``dfa_match_spans_plain`` (what the span kernel is held to on the
    card) against the JAX module's numpy backend at the widths of the
    kernel's paths and their edges: empty rows and rows of the full width,
    matches ending at the row's end (``p == len``), empty matches (``x*``,
    ``^$``), and patterns anchored at either end."""
    rng = np.random.default_rng(width)
    n = 61
    alphabet = np.frombuffer(b"aeiou bcx0123456789", dtype=np.uint8)
    lens = rng.integers(0, width + 1, n).astype(np.int32)
    lens[:4] = [0, width, 0, min(width, 1)]
    chars = alphabet[rng.integers(0, alphabet.size, (n, width))]
    chars[1, width - 1] = ord("e")          # a match at the row's end
    chars[np.arange(width)[None] >= lens[:, None]] = 0
    tc, tl = torch.from_numpy(chars), torch.from_numpy(lens)
    for pat in SPAN_PATTERNS:
        rx, jrx = RX.compile_regex(pat), JRX.compile_regex(pat)
        chosen, mlen = K.dfa_match_spans(K.dfa_tables(rx, "cpu"), tc, tl)
        jc, jm = JRX.dfa_match_spans(np, jrx, chars, lens)
        np.testing.assert_array_equal(chosen.numpy(), jc, err_msg=pat)
        np.testing.assert_array_equal(mlen.numpy(), jm, err_msg=pat)
        if pat == r"[aeiou]+":
            ends = np.arange(width + 1)[None] + jm
            assert (jc & (jm > 0) & (ends == lens[:, None])).any()
        if pat in (r"x*", r"^$"):
            assert (jc & (jm == 0)).any()


def test_replace_and_first_match_equal_the_reference():
    chars, lens = seeded_rows(seed=4)
    tc, tl = torch.from_numpy(chars), torch.from_numpy(lens)
    for pat, rep in ((r"\d+", "#"), (r"x*", "Q"), (r"[ab]", "")):
        rx, jrx = RX.compile_regex(pat), JRX.compile_regex(pat)
        chosen, mlen = K.dfa_match_spans(K.dfa_tables(rx, "cpu"), tc, tl)
        jc, jm = JRX.dfa_match_spans(np, jrx, chars, lens)
        rb = rep.encode()
        rep_row = np.zeros((chars.shape[0], 4), dtype=np.uint8)
        rep_row[:, :len(rb)] = list(rb)
        want = JRX.replace_matches(np, chars, lens, jc, jm, rep_row,
                                   np.full(chars.shape[0], len(rb),
                                           dtype=np.int32), 128)
        got = RX.replace_matches(tc, tl, chosen, mlen, rb, 128)
        assert [bytes(r[:n]) for r, n in zip(got[0].numpy(),
                                             got[1].numpy())] == \
            [bytes(r[:n]) for r, n in zip(want[0], want[1])]
        s, ln, found = RX.first_match_span(chosen, mlen)
        js, jl, jf = JRX.first_match_span(np, jc, jm, lens)
        np.testing.assert_array_equal(s.numpy(), js)
        np.testing.assert_array_equal(ln.numpy(), jl)
        np.testing.assert_array_equal(found.numpy(), jf)


# --------------------------------------------------------------------------
# the reference's tests/test_regexp.py, through both packages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pat", PATTERNS[:14])
def test_rlike_matches_python_re(port, ref, table, pat):
    got = port_rows(port, table, lambda df, f: [f.rlike(df.s, pat)
                                                .alias("m")])
    want = ref_rows(ref, table, lambda df, f: [f.rlike(df.s, pat)
                                               .alias("m")])
    assert got == want
    assert [r["m"] for r in got] == [bool(pyre.search(pat, s))
                                     for s in STRS], pat


def test_rlike_runs_through_the_search_kernel(port, table, monkeypatch):
    calls, rec = recording("dfa_search")
    monkeypatch.setattr(K, "dfa_search", rec)
    df = port.create_dataframe(table)
    df.select(df.s.rlike(r"\d+").alias("m")).collect()
    port.sql("SELECT s FROM t WHERE s REGEXP 'o$' OR s RLIKE '^a'").collect()
    assert len(calls) >= 3


def test_unsupported_patterns_fall_back(port, table):
    """The JAX package's host cases raise, naming the construct."""
    df = port.create_dataframe(table)
    for pat, frag in [(r"(a)\1", "backreference"),
                      (r"a(?=b)", "group construct"),
                      (r"a*+b", "possessive"), (r"ab\Z", "anchor"),
                      (r"\bword", "anchor")]:
        with pytest.raises(NotImplementedError, match=frag):
            df.select(F.rlike(df.s, pat)).collect()
    with pytest.raises(NotImplementedError, match="lazy"):
        df.select(F.regexp_replace(df.s, r"a*?b", "X")).collect()


def test_rlike_lazy_and_input_anchors(port, ref, table):
    pats = (r"a*?b", r"o+?", r"\Aab", r"ab\z", r"\Ax.*\z")

    def cols(df, f):
        return [f.rlike(df.s, p).alias(f"m{i}") for i, p in enumerate(pats)]
    got = port_rows(port, table, cols)
    assert got == ref_rows(ref, table, cols)
    for r, s in zip(got, STRS):
        for i, p in enumerate(pats):
            py = p.replace(r"\A", "^").replace(r"\z", "$")
            assert r[f"m{i}"] == (pyre.search(py, s) is not None)


@pytest.mark.parametrize("pat,rep", [
    (r"\d+", "#"), (r"o", "0"), (r"\s+", "_"), (r"[aeiou]", ""),
    (r"z*y", "Q"),
])
def test_regexp_replace(port, ref, table, pat, rep):
    def cols(df, f):
        return [f.regexp_replace(df.s, pat, rep).alias("r")]
    got = port_rows(port, table, cols)
    assert got == ref_rows(ref, table, cols)
    assert [r["r"] for r in got] == [pyre.sub(pat, rep, s) for s in STRS]


def test_regexp_replace_group_ref_raises(port, table):
    df = port.create_dataframe(table)
    with pytest.raises(NotImplementedError, match="group references"):
        df.select(F.regexp_replace(df.s, r"(\d)", "[$1]")).collect()


def test_regexp_extract(port, ref, table):
    def cols(df, f):
        return [f.regexp_extract(df.s, r"\d+", 0).alias("whole"),
                f.regexp_extract(df.s, r"(\d+)", 1).alias("g1")]
    got = port_rows(port, table, cols)
    assert got == ref_rows(ref, table, cols)
    for r, s in zip(got, STRS):
        m = pyre.search(r"\d+", s)
        assert r["whole"] == r["g1"] == (m.group(0) if m else "")
    df = port.create_dataframe(table)
    with pytest.raises(NotImplementedError, match="capture group 2"):
        df.select(F.regexp_extract(df.s, r"(\w)@(\w)", 2)).collect()


def test_regexp_extract_all(port, ref, table):
    """Group 1 of a pattern that is one group, and group 0: on the device
    path in the port (the JAX package runs regexp_extract_all on its
    host)."""
    def cols(df, f):
        return [f.regexp_extract_all(df.s, r"(\d+)", 1).alias("all"),
                f.regexp_extract_all(df.s, r"[a-c]", 0).alias("abc")]
    got = port_rows(port, table, cols)
    assert got == ref_rows(ref, table, cols)
    assert [r["all"] for r in got] == [pyre.findall(r"(\d+)", s)
                                       for s in STRS]


def test_split(port, ref, table):
    def cols(df, f):
        return [f.split(df.s, ",").alias("parts"),
                f.split(df.s, r"\s+").alias("ws"),
                f.split(df.s, ",", 2).alias("lim")]
    got = port_rows(port, table, cols)
    assert got == ref_rows(ref, table, cols)
    for r, s in zip(got, STRS):
        assert r["parts"] == s.split(","), s
        assert r["ws"] == pyre.split(r"\s+", s), s
        assert r["lim"] == s.split(",", 1), s


def test_split_runs_through_the_span_kernel(port, table, monkeypatch):
    calls, rec = recording("dfa_match_spans")
    monkeypatch.setattr(K, "dfa_match_spans", rec)
    port.sql("SELECT split(s, ',') p, regexp_extract(s, '[0-9]+', 0) e, "
             "regexp_replace(s, 'o', '0') r FROM t").collect()
    assert len(calls) == 3


def test_str_to_map_is_not_ported(port):
    with pytest.raises(NotImplementedError, match="str_to_map"):
        port.sql("SELECT str_to_map(s) FROM t").collect()


def test_split_then_explode_raises_naming_explode(port):
    with pytest.raises(NotImplementedError, match="explode"):
        port.sql("SELECT explode(split(s, ',')) FROM t").collect()


def test_dfa_rejects_state_explosion():
    with pytest.raises(RX.RegexUnsupported):
        RX.compile_regex("(a|b)*a(a|b){15}")


def test_split_limit_zero_is_spark_3s(port, ref):
    """Spark 3 reads limit 0 as -1 and keeps trailing empty parts; the
    JAX package drops them as Java's String.split(regex, 0) does."""
    t = pa.table({"u": [0, 1, 2, 3], "s": ["a,b,,", ",,", "", "a,b"]})

    def cols(df, f):
        return [f.split(df.s, ",", 0).alias("p")]
    got = port_rows(port, t, cols)
    assert [r["p"] for r in got] == [["a", "b", "", ""], ["", "", ""], [""],
                                     ["a", "b"]]
    assert [r["p"] for r in ref_rows(ref, t, cols)] == [
        ["a", "b"], [], [""], ["a", "b"]]


def test_regexp_replace_empty_match_no_truncation(port, ref):
    t = pa.table({"u": [0], "s": ["bbbbbbbb"]})

    def cols(df, f):
        return [f.regexp_replace(df.s, "z*", "Q").alias("r")]
    got = port_rows(port, t, cols)
    assert got == ref_rows(ref, t, cols)
    assert got[0]["r"] == "".join("Q" + ch for ch in "bbbbbbbb") + "Q"


def test_negated_class_matches_nul_byte(port, ref):
    t = pa.table({"u": [0], "s": ["a\x00b"]})

    def cols(df, f):
        return [f.rlike(df.s, "a[^x]b").alias("m")]
    assert port_rows(port, t, cols) == ref_rows(ref, t, cols) == [
        {"u": 0, "m": True}]


def test_malformed_counted_brace_is_rejected():
    for pat in ("a{-1}", "a{3,1}", "a{,2}"):
        with pytest.raises(RX.RegexUnsupported):
            RX.compile_regex(pat)


def test_alternation_extent_divergence_raises(port):
    """'a|ab' is leftmost-first in Java ('a') and leftmost-longest in a
    DFA ('ab'): replace, extract and split raise (the JAX package runs them
    on its host)."""
    df = port.create_dataframe(pa.table({"s": ["ab", "aab", "b"]}))
    for col in (F.regexp_replace(df.s, r"a|ab", "X"),
                F.regexp_extract(df.s, r"a|ab", 0), F.split(df.s, r"a|ab")):
        with pytest.raises(NotImplementedError, match="leftmost"):
            df.select(col).collect()


def test_alternation_same_length_stays_on_device(port, ref, table):
    def cols(df, f):
        return [f.regexp_replace(df.s, r"foo|dot", "X").alias("r")]
    got = port_rows(port, table, cols)
    assert got == ref_rows(ref, table, cols)
    assert [r["r"] for r in got] == [pyre.sub(r"foo|dot", "X", s)
                                     for s in STRS]


def test_rlike_alternation_still_on_device(port, ref, table):
    def cols(df, f):
        return [f.rlike(df.s, r"a|ab").alias("m")]
    got = port_rows(port, table, cols)
    assert got == ref_rows(ref, table, cols)


def test_sql_operators_and_functions_match_reference(port, ref):
    sql = """SELECT u, s RLIKE '[0-9]' a, s REGEXP '^a' b,
        regexp_like(s, 'o+') c, regexp_replace(s, '[.,]', ';') d,
        regexp_extract(s, '[a-z]+', 0) e, split(s, '[.,]') f
        FROM t WHERE NOT s RLIKE '^$' ORDER BY u"""
    got = port.sql(sql).collect().to_pylist()
    assert got == ref.sql(sql).collect().to_pylist()
    assert len(got) == len(STRS) - 1


def test_seeded_strings_through_both_sessions():
    """numpy-seeded rows (nulls, multi-byte characters) through both
    packages' SQL."""
    rng = np.random.default_rng(9)
    alphabet = np.array(list("ab1 2,.xé中"))
    vals = ["".join(rng.choice(alphabet, k))
            for k in rng.integers(0, 16, 150)]
    for i in rng.integers(0, 150, 10):
        vals[i] = None
    t = pa.table({"u": np.arange(150), "s": pa.array(vals, pa.string())})
    sql = """SELECT u, s RLIKE '[0-9]+' a, regexp_replace(s, '[0-9]', '#') b,
        regexp_extract(s, 'é+', 0) c, split(s, ',') d,
        regexp_extract_all(s, '[ab]+', 0) e FROM t ORDER BY u"""
    port = srt.session(device="cpu")
    port.create_dataframe(t, num_partitions=2).createOrReplaceTempView("t")
    ref = jsrt.session()
    ref.create_dataframe(t, num_partitions=2).createOrReplaceTempView("t")
    got = port.sql(sql).collect().to_pylist()
    assert got == ref.sql(sql).collect().to_pylist()
