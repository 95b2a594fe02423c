"""Number → words normalization.

Reimplements the reference's number expansion (reference: text/numbers.py:66-73)
without the ``inflect`` dependency: commas removed, pounds/dollars verbalized,
decimals spelled with "point", ordinals and cardinals expanded, and the
year-style reading for 1000 < n < 3000 (reference: text/numbers.py:49-63).
"""

import re

_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALES = ["", " thousand", " million", " billion", " trillion",
           " quadrillion", " quintillion", " sextillion", " septillion"]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    if ones:
        return f"{_TENS[tens]}-{_ONES[ones]}"
    return _TENS[tens]


def _three_digits(n: int, andword: str) -> str:
    hundreds, rest = divmod(n, 100)
    parts = []
    if hundreds:
        parts.append(f"{_ONES[hundreds]} hundred")
    if rest or not hundreds:
        if hundreds and andword:
            parts.append(f"{andword} {_two_digits(rest)}")
        else:
            parts.append(_two_digits(rest))
    return " ".join(parts)


def number_to_words(n: int, andword: str = "and", zero: str = "zero",
                    group: int = 0) -> str:
    """English verbalization of a non-negative integer.

    ``andword``/``zero``/``group`` follow the subset of behaviors the
    reference relies on (inflect-style): ``group=2`` reads digit pairs
    ("1999" → "nineteen, ninety-nine"), ``zero="oh"`` reads zero digits
    as "oh", and groups of thousands are joined with ", ".
    """
    if n < 0:
        return "minus " + number_to_words(-n, andword=andword, zero=zero, group=group)

    if group == 2:
        digits = str(n)
        if len(digits) % 2 == 1:
            pairs = [digits[:1]] + [digits[i:i + 2] for i in range(1, len(digits), 2)]
        else:
            pairs = [digits[i:i + 2] for i in range(0, len(digits), 2)]
        words = []
        for pair in pairs:
            v = int(pair)
            if pair == "00":
                words.append("hundred" if zero == "zero" else zero + " " + zero)
            elif len(pair) == 2 and pair[0] == "0":
                words.append(f"{zero} {_ONES[v]}")
            else:
                words.append(_two_digits(v) if v < 100 else _three_digits(v, ""))
        return ", ".join(words)

    if n == 0:
        return zero

    groups = []
    scale_idx = 0
    while n > 0:
        n, chunk = divmod(n, 1000)
        if chunk:
            groups.append(_three_digits(chunk, andword) + _SCALES[scale_idx])
        scale_idx += 1
    return ", ".join(reversed(groups))


def number_to_ordinal_words(n: int, andword: str = "and") -> str:
    words = number_to_words(n, andword=andword)
    head, sep, last = words.rpartition(" ")
    prefix = head + sep
    hy_head, hy_sep, hy_last = last.rpartition("-")
    prefix += hy_head + hy_sep
    if hy_last in _ORDINAL_IRREGULAR:
        return prefix + _ORDINAL_IRREGULAR[hy_last]
    if hy_last.endswith("y"):
        return prefix + hy_last[:-1] + "ieth"
    return prefix + hy_last + "th"


def _remove_commas(m):
    return m.group(1).replace(",", "")


def _expand_decimal_point(m):
    return m.group(1).replace(".", " point ")


def _expand_dollars(m):
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        cent_unit = "cent" if cents == 1 else "cents"
        return f"{dollars} {dollar_unit}, {cents} {cent_unit}"
    elif dollars:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        return f"{dollars} {dollar_unit}"
    elif cents:
        cent_unit = "cent" if cents == 1 else "cents"
        return f"{cents} {cent_unit}"
    return "zero dollars"


def _expand_ordinal(m):
    return number_to_ordinal_words(int(m.group(0)[:-2]))


def _expand_number(m):
    num = int(m.group(0))
    # year-style reading (reference: text/numbers.py:49-63)
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        elif 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        elif num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        else:
            return number_to_words(num, andword="", zero="oh",
                                   group=2).replace(", ", " ")
    return number_to_words(num, andword="")


def normalize_numbers(text: str) -> str:
    text = re.sub(_comma_number_re, _remove_commas, text)
    text = re.sub(_pounds_re, r"\1 pounds", text)
    text = re.sub(_dollars_re, _expand_dollars, text)
    text = re.sub(_decimal_number_re, _expand_decimal_point, text)
    text = re.sub(_ordinal_re, _expand_ordinal, text)
    text = re.sub(_number_re, _expand_number, text)
    return text
