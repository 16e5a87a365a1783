from custrings.nvtext import *  # noqa
