from custrings.nvcategory import *  # noqa
