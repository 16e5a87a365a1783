"""Public API surface tests: the README tips demo end-to-end (BASELINE
config 1) plus convert/datetime/stats coverage."""

import numpy as np
import pytest

from custrings import nvcategory, nvstrings, nvtext


TIPS_SAMPLE = [
    "16.99,1.01,Female,No,Sun,Dinner,2",
    "10.34,1.66,Male,No,Sun,Dinner,3",
    "21.01,3.5,Male,No,Sun,Dinner,3",
    "23.68,3.31,Male,No,Mon,Lunch,2",
    "24.59,3.61,Female,No,Tues,Dinner,4",
    "25.29,4.71,Male,No,Sat,Dinner,4",
    "8.77,2.0,Male,No,Thur,Lunch,2",
    "26.88,3.12,Male,No,Fri,Dinner,4",
]


def test_readme_tips_demo():
    gpu_lines = nvstrings.to_device(TIPS_SAMPLE)
    gpu_columns = gpu_lines.split(",")
    gpu_day_of_week = gpu_columns[4]
    for idx, day in enumerate(
        ["Sun", "Mon", "Tues", "Wed", "Thur", "Fri", "Sat"]
    ):
        gpu_day_of_week = gpu_day_of_week.replace(day, str(idx), regex=False)
    cat = nvcategory.from_strings(gpu_columns[4])
    assert cat.keys().to_host() == ["Fri", "Mon", "Sat", "Sun", "Thur",
                                    "Tues"]
    assert gpu_day_of_week.to_host() == ["0", "0", "0", "1", "2", "6", "4",
                                         "5"]
    # numeric column parse
    tips = gpu_columns[1].stof()
    assert tips[0] == pytest.approx(1.01, rel=1e-5)


def test_getitem_and_iter():
    s = nvstrings.to_device(["a", "b", "c", "d"])
    assert s[1].to_host() == ["b"]
    assert s[1:3].to_host() == ["b", "c"]
    assert s[[0, 3]].to_host() == ["a", "d"]
    assert list(s) == ["a", "b", "c", "d"]


def test_stoi_stol():
    s = nvstrings.to_device(["1234", "-876", "5.3", "hello", "", None])
    assert s.stoi() == [1234, -876, 5, 0, 0, None]
    s2 = nvstrings.to_device(["123456789012345"])
    assert s2.stol() == [123456789012345]


def test_stof_stod():
    s = nvstrings.to_device(
        ["1234.0", "-876.5", "5.3e2", ".5", "-.02", "", "nan", "inf"]
    )
    got = s.stod()
    exp = [1234.0, -876.5, 530.0, 0.5, -0.02, 0.0, float("nan"),
           float("inf")]
    for g, e in zip(got, exp):
        if np.isnan(e):
            assert np.isnan(g)
        else:
            assert g == pytest.approx(e, rel=1e-9)


def test_htoi():
    s = nvstrings.to_device(["1234", "ABCDEF", "0xDEADBEEF", "ff"])
    assert s.htoi() == [0x1234, 0xABCDEF, 0xDEADBEEF, 0xFF]


def test_ip2int_roundtrip():
    s = nvstrings.to_device(["192.168.0.1", "10.0.0.255", "0.0.0.0"])
    ints = s.ip2int()
    assert ints == [3232235521, 167772415, 0]
    back = nvstrings.int2ip(ints)
    assert back.to_host() == ["192.168.0.1", "10.0.0.255", "0.0.0.0"]


def test_itos_ftos():
    assert nvstrings.itos([0, -25, 314]).to_host() == ["0", "-25", "314"]
    got = nvstrings.dtos(np.array([0.0, 1.5, -2.75, 1234567890.5],
                                  np.float64)).to_host()
    assert got[0] == "0.0"
    assert got[1] == "1.5"
    assert got[2] == "-2.75"
    # 10 significant digits + scientific beyond 1e9 (convert.cu)
    assert got[3].startswith("1.23456789")
    assert got[3].endswith("e+09")
    # float32 flavor rounds through single precision
    f32 = nvstrings.ftos(np.array([1.5], np.float32)).to_host()
    assert f32 == ["1.5"]


def test_booleans():
    s = nvstrings.to_device(["True", "False", "true", None])
    assert s.to_booleans() == [True, False, False, None]
    b = nvstrings.from_booleans([True, False])
    assert b.to_host() == ["True", "False"]


def test_hash():
    s = nvstrings.to_device(["aaa", "bbb", "aaa", ""])
    h = s.hash()
    assert h[0] == h[2]
    assert h[0] != h[1]


def test_timestamp_roundtrip():
    got = nvstrings.int2timestamp([1553085296, 1582934400]).to_host()
    assert got == ["2019-03-20T12:34:56Z", "2020-02-29T00:00:00Z"]
    s = nvstrings.to_device(["2019-03-20T12:34:56Z", "2020-02-29T23:59:59Z"])
    assert s.timestamp2int() == [1553085296, 1583020799]
    ms = s.timestamp2int(units="ms")
    assert ms == [1553085296000, 1583020799000]


def test_timestamp_format():
    s = nvstrings.to_device(["05/20/2019 02:30 PM"])
    got = s.timestamp2int(format="%m/%d/%Y %I:%M %p", units="m")
    import datetime as dt

    exp = int(
        dt.datetime(2019, 5, 20, 14, 30, tzinfo=dt.timezone.utc).timestamp()
        // 60
    )
    assert got == [exp]


def test_get_info():
    s = nvstrings.to_device(["Hello", "world", "Hello", None, ""])
    info = s.get_info()
    assert info["total_strings"] == 5
    assert info["null_strings"] == 1
    assert info["empty_strings"] == 1
    assert info["unique_strings"] == 4  # null, "", Hello, world
    assert info["uppercase_count"] == 2


def test_nvtext_api():
    s = nvstrings.to_device(["hello world", "goodbye world"])
    assert nvtext.token_count(s) == [2, 2]
    assert nvtext.tokenize(s).size() == 4
    assert nvtext.unique_tokens(s).to_host() == ["goodbye", "hello",
                                                 "world"]
    assert nvtext.edit_distance(s, "hello world") == [0, 7]


def test_partition_api():
    s = nvstrings.to_device(["a_b", None])
    rows = s.partition("_")
    assert rows[0].to_host() == ["a", "_", "b"]
    assert rows[1].to_host() == [None, None, None]


def test_split_record_api():
    s = nvstrings.to_device(["a_b", None, "c"])
    recs = s.split_record("_")
    assert recs[0].to_host() == ["a", "b"]
    assert recs[1] is None
    assert recs[2].to_host() == ["c"]


def test_from_csv(tmp_path):
    p = tmp_path / "t.csv"
    p.write_text("a,b\n1,x\n2,y\n")
    s = nvstrings.from_csv(str(p), 1)
    # reference skips the header line (util.cu:68-80)
    assert s.to_host() == ["x", "y"]


def test_ipc_roundtrip():
    s = nvstrings.to_device(["a", None, "ccc"])
    blob = s.get_ipc_data()
    s2 = nvstrings.create_from_ipc(blob)
    assert s2.to_host() == ["a", None, "ccc"]


def test_tracing():
    from custrings.utils import tracing

    tracing.reset()
    with tracing.enabled():
        with tracing.op("upper", nbytes=100):
            nvstrings.to_device(["x"]).upper()
    rep = tracing.report()
    assert "upper" in rep


def test_from_csv_tweets_reference(tmp_path):
    # parity with python/tests/test_memory.py::test_from_csv, on a CSV
    # written from the seeded tweet generator: the text is column 7, the
    # header line is skipped, empty fields read as null, and only the
    # OUTER quote pair is stripped (doubled quotes inside stay verbatim)
    from benchmarks.corpus import tweets

    rows = tweets(40, 11)
    rows[3] = 'a, b ""Not Found"" page even in homepage'
    path = tmp_path / "tweets.csv"
    with open(path, "w", encoding="utf-8") as f:
        f.write("id,a,b,c,d,e,f,text\n")
        for i, r in enumerate(rows):
            text = '"%s"' % r if r and "," in r else (r or "")
            f.write(f"{i},x,y,z,1,2,3,{text}\n")
    got = nvstrings.from_csv(str(path), 7).to_host()
    assert got == [r if r else None for r in rows]
    assert got[3].endswith('""Not Found"" page even in homepage')
    assert nvstrings.from_csv(str(path), 7, 5).to_host() == got[:5]


def test_from_strings_concat():
    s1 = nvstrings.to_device(["dog and cat", None, "accénted", ""])
    got = nvstrings.from_strings(s1, s1)
    assert got.to_host() == ["dog and cat", None, "accénted", ""] * 2


def test_add_strings_api():
    s1 = nvstrings.to_device(["dog and cat", None, "accénted", ""])
    s2 = nvstrings.to_device(["aaa", None, "", "bbb"])
    got = s1.add_strings(s2)
    assert got.to_host() == ["dog and cat", None, "accénted", "", "aaa",
                             None, "", "bbb"]


def test_hash_reference_vector():
    # exact murmur3 values from python/tests/test_convert.py::test_hash
    s = nvstrings.to_device(
        ["1234", "5678", "90", None, "-876", "543.2", "-0.12", ".55",
         "-.002", "", "de", "abc123", "123abc", "456e", "-1.78e+5"]
    )
    assert s.hash() == [
        1762063109, 3008518326, 3419725934, None, 1225421472, 2952354928,
        2093756495, 1292375090, 2098378342, 1257683291, 3758453927,
        213530502, 2957649541, 4248160425, 2735531987,
    ]


def test_convert_reference_vectors():
    corpus = ["1234", "5678", "90", None, "-876", "543.2", "-0.12", ".55",
              "-.002", "", "de", "abc123", "123abc", "456e", "-1.78e+5"]
    s = nvstrings.to_device(corpus)
    assert s.stoi() == [1234, 5678, 90, None, -876, 543, 0, 0, 0, 0, 0, 0,
                        123, 456, -1]
    got = s.stof()
    exp = [1234.0, 5678.0, 90.0, None, -876.0, 543.2000122070312,
           -0.11999999731779099, 0.550000011920929, -0.0020000000949949026,
           0.0, 0.0, 0.0, 123.0, 456.0, -178000.0]
    for g, e in zip(got, exp):
        assert (g is None and e is None) or g == pytest.approx(e, rel=1e-7)
    assert nvstrings.to_device(["1234", "ABCDEF", "1A2", "cafe"]).htoi() == [
        4660, 11259375, 418, 51966,
    ]


def test_ip_reference_vectors():
    s = nvstrings.to_device(["192.168.0.1", "10.0.0.1", None, "", "hello",
                             "41.186.0.1", "41.197.0.1"])
    assert s.ip2int() == [3232235521, 167772161, None, 0, 0, 700055553,
                          700776449]
    got = nvstrings.int2ip(
        [3232235521, 167772161, None, 0, 0, 700055553, 700776449]
    )
    assert got.to_host() == ["192.168.0.1", "10.0.0.1", "0.0.0.0",
                             "0.0.0.0", "0.0.0.0", "41.186.0.1",
                             "41.197.0.1"]


def test_ftos_dtos_reference_vectors():
    got = nvstrings.ftos(
        np.array([0, 103, -254848.5929, 8395794.248339, np.nan, np.inf],
                 np.float32)
    ).to_host()
    assert got == ["0.0", "103.0", "-254848.5938", "8395794.0", "NaN",
                   "Inf"]
    got = nvstrings.dtos(
        np.array([0, 103342.313, -25.4294, 839542223232.794248339, np.nan],
                 np.float64)
    ).to_host()
    assert got == ["0.0", "103342.313", "-25.4294", "8.395422232e+11",
                   "NaN"]


def test_booleans_reference():
    s = nvstrings.to_device(["true", "false", None, "", "true", "True"])
    assert s.to_booleans() == [False, False, None, False, False, True]
    assert s.to_booleans(true="true") == [True, False, None, False, True,
                                          False]
    got = nvstrings.from_booleans([True, False, False, True], nulls=[11])
    assert got.to_host() == ["True", "False", None, "True"]


def test_is_empty_null_none():
    s = nvstrings.to_device(["true", "false", None, "", "true"])
    assert s.is_empty() == [False, False, None, True, False]


@pytest.mark.parametrize(
    "func", ["lower", "upper", "swapcase", "capitalize", "title", "strip"]
)
def test_allnulls(func):
    s = nvstrings.to_device([None, None, None])
    assert getattr(s, func)().to_host() == [None, None, None]


def test_cat_multiple():
    s1 = nvstrings.to_device(["a", "b"])
    s2 = nvstrings.to_device(["c", "d"])
    s3 = nvstrings.to_device(["e", "f"])
    got = s1.cat([s2, s3], sep=":")
    assert got.to_host() == ["a:c:e", "b:d:f"]


def test_scalar_scatter():
    s = nvstrings.to_device(["a", "b", "c", "d"])
    got = s.scalar_scatter("X", [1, 3])
    assert got.to_host() == ["a", "X", "c", "X"]


def test_compare_reference_vector():
    s = nvstrings.to_device(["hello", "there", "world", "accéntéd", None,
                             ""])
    assert s.compare("there") == [-12, 0, 3, -19, None, -1]


def test_find_reference_vectors():
    s = nvstrings.to_device(["hello", "there", "world", "accéntéd", None,
                             ""])
    assert s.find("o") == [4, -1, 1, -1, None, -1]
    assert s.find_from("r") == [-1, 3, 2, -1, None, -1]
    assert s.rfind("d") == [-1, -1, 4, 7, None, -1]
    assert s.find_multiple(["e", "o", "d"]) == [
        [1, 4, -1], [2, -1, -1], [-1, 1, 4], [-1, -1, 7],
        [None, None, None], [-1, -1, -1],
    ]


def test_timestamp2int_tz_device():
    # %z is fixed +HHMM; the reference ADDS the offset
    # (datetime.cu:84 {'z',5}; :261-270; :308-318) — we mirror that.
    from custrings import nvstrings as nvs

    s = nvs.to_device(
        [
            "2019-03-20T12:34:56+0530",
            "2019-03-20T12:34:56-0130",
            "2019-03-20T12:34:56+0000",
            None,
        ]
    )
    base = 1553085296
    got = list(s.timestamp2int("%Y-%m-%dT%H:%M:%S%z", "s"))
    assert got == [base + 330 * 60, base - 90 * 60, base, 0]
    got_m = list(s.timestamp2int("%Y-%m-%dT%H:%M:%S%z", "m"))[:2]
    assert got_m == [base // 60 + 330, base // 60 - 90]


def test_former_package_name_is_a_deprecated_alias():
    # the package's former name is the one other top-level package
    # beginning with "custrings_" beside it
    import importlib
    import os
    import pkgutil
    import sys

    import custrings

    root = os.path.dirname(os.path.dirname(custrings.__file__))
    (old,) = [m.name for m in pkgutil.iter_modules([root])
              if m.ispkg and m.name.startswith("custrings_")]
    sys.modules.pop(old, None)
    with pytest.warns(DeprecationWarning, match="import custrings"):
        alias = importlib.import_module(old)
    assert alias is custrings
    for sub in ("nvstrings", "parallel.dist", "ops.unique"):
        assert importlib.import_module(f"{old}.{sub}") is (
            importlib.import_module(f"custrings.{sub}")
        )
    mod = importlib.import_module(f"{old}.nvcategory")
    assert mod.__spec__.name == "custrings.nvcategory"
    assert mod.from_strings(nvstrings.to_device(["b", "a"])).keys_size() == 2
