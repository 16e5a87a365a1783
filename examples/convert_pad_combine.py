"""Conversions, padding, and concatenation walkthrough — port of the
reference notebooks python/notebooks/test_convert.ipynb,
test_pad.ipynb, and test_combine.ipynb.

Run:  python examples/convert_pad_combine.py
      JAX_PLATFORMS=cpu python examples/convert_pad_combine.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from custrings import nvstrings

# ---- test_convert.ipynb: number parsing + formatting round trips -------
nums = nvstrings.to_device(
    ["1234", "5678", "90", None, "-876", "543.2", "-0.12", ".55", "-.002"]
)
print("stoi:", nums.stoi())
print("stof:", nums.stof())
print("htoi('1A'):", nvstrings.to_device(["1A", "ff", "0x7f"]).htoi())
print("itos:", nvstrings.itos([0, -5, 1234567]).to_host())
print("ftos:", nvstrings.ftos([0.25, -1.5e7, float("nan")]).to_host())
print("ip2int:", nvstrings.to_device(["192.168.0.1"]).ip2int())
print("int2ip:", nvstrings.int2ip([3232235521]).to_host())

# ---- test_pad.ipynb: fixed-width layout ---------------------------------
strs = nvstrings.to_device(["hello", "there", "world", "1234", "-1234", None])
print("pad(5):      ", strs.pad(5).to_host())
print("pad(7,right):", strs.pad(7, "right").to_host())
print("pad(9,both): ", strs.pad(9, "both", ".").to_host())
print("ljust(7):    ", strs.ljust(7).to_host())
print("rjust(10):   ", strs.rjust(10).to_host())
print("center(10):  ", strs.center(10).to_host())
print("zfill(6):    ", strs.zfill(6).to_host())

# ---- test_combine.ipynb: cat / join -------------------------------------
s1 = nvstrings.to_device(["abc", "def", None, "jkl", "mno"])
s2 = nvstrings.to_device(["1", "2", "3", None, "5"])
print("cat():              ", s1.cat().to_host())
print("cat(sep=':'):       ", s1.cat(sep=":").to_host())
print("cat(sep,na_rep):    ", s1.cat(sep=":", na_rep="_").to_host())
print("cat(list,sep,na):   ", s1.cat(["1", "2", "3", "4", "5"], sep=":", na_rep="_").to_host())
print("cat(strs):          ", s1.cat(s2).to_host())
print("cat(strs,sep):      ", s1.cat(s2, sep=":").to_host())
print("cat(strs,sep,na):   ", s1.cat(s2, sep=":", na_rep="_").to_host())
print("join():             ", s1.join().to_host())
