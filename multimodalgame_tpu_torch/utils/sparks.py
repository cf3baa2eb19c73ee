"""Unicode sparklines and letter renderings for the log's message dumps.

A copy of ``multimodalgame_tpu/utils/sparks.py``: bar height is
``round(x / (max(nums) / (len(PARTS) - 1)))`` per element (reference
sparks.py:12-14).
"""

PARTS = " ▁▂▃▄▅▆▇▉"


def sparks(nums):
    fraction = max(nums) / float(len(PARTS) - 1)
    return "".join(PARTS[int(round(x / fraction))] for x in nums)


def bin_to_alpha(binary: str) -> str:
    """Render a binary message string as letters, 5 bits per symbol
    (reference model.py:991-998)."""
    ret = []
    interval = 5
    offset = 65
    for i in range(0, len(binary), interval):
        val = int(binary[i:i + interval], 2)
        ret.append(chr(offset + val))
    return " ".join(ret)
