"""The README tips demo (reference README.md:12-49)."""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from custrings import nvcategory, nvstrings

lines = [
    "16.99,1.01,Female,No,Sun,Dinner,2",
    "10.34,1.66,Male,No,Sun,Dinner,3",
    "21.01,3.5,Male,No,Sun,Dinner,3",
    "23.68,3.31,Male,No,Mon,Lunch,2",
]

gpu_lines = nvstrings.to_device(lines)
gpu_columns = gpu_lines.split(",")
gpu_day_of_week = gpu_columns[4]
for idx, day in enumerate(["Sun", "Mon", "Tues", "Wed", "Thur", "Fri", "Sat"]):
    gpu_day_of_week = gpu_day_of_week.replace(day, str(idx), regex=False)

cat = nvcategory.from_strings(gpu_columns[4])
print("keys:   ", cat.keys().to_host())
print("encoded:", gpu_day_of_week.to_host())
