"""Self-contained zh/en text normalization (number/date/time/unit reading).

Fills the role of WeTextProcessing / wetext in the reference
(utils/front.py:88-111): non-standard words → speakable words. Implemented
from scratch as rule pipelines; when the optional WeTextProcessing package is
present it is preferred (same graceful ladder as the reference).
"""
from __future__ import annotations

import re
from typing import Callable, List, Tuple

# ---------------------------------------------------------------------------
# Chinese number reading
# ---------------------------------------------------------------------------

ZH_DIGITS = "零一二三四五六七八九"
ZH_UNITS = ["", "十", "百", "千"]
ZH_GROUPS = ["", "万", "亿", "万亿"]


def zh_digits(s: str) -> str:
    """Digit-by-digit reading (years). '203'→'二零三'."""
    return "".join(ZH_DIGITS[int(c)] if c.isdigit() else c for c in s)


def zh_digits_phone(s: str) -> str:
    """Telephone reading: 1 is read 幺 (WeTextProcessing convention).
    '135'→'幺三五'."""
    return "".join(("幺" if c == "1" else ZH_DIGITS[int(c)])
                   if c.isdigit() else c for c in s)


def _zh_int_group(n: int) -> str:
    """Read 0 < n < 10000."""
    out = []
    started = False
    zero_pending = False
    for i, unit in enumerate(reversed(ZH_UNITS)):
        power = 10 ** (3 - i)
        d = (n // power) % 10
        if d == 0:
            if started:
                zero_pending = True
            continue
        if zero_pending:
            out.append("零")
            zero_pending = False
        out.append(ZH_DIGITS[d] + unit)
        started = True
    return "".join(out)


def zh_int(n: int) -> str:
    if n == 0:
        return "零"
    if n < 0:
        return "负" + zh_int(-n)
    groups: List[int] = []
    while n > 0:
        groups.append(n % 10000)
        n //= 10000
    out: List[str] = []
    for gi in range(len(groups) - 1, -1, -1):
        g = groups[gi]
        if g == 0:
            continue
        txt = _zh_int_group(g)
        if gi < len(groups) - 1 and g < 1000 and out:
            out.append("零")
        out.append(txt + ZH_GROUPS[gi])
    s = "".join(out)
    # idiomatic: 一十X → 十X at the very start
    if s.startswith("一十"):
        s = s[1:]
    s = s.replace("零零", "零")
    return s


def zh_number(s: str) -> str:
    """Read a decimal number string in Chinese."""
    neg = s.startswith("-")
    if neg:
        s = s[1:]
    if "." in s:
        a, b = s.split(".", 1)
        txt = (zh_int(int(a)) if a else "零") + "点" + zh_digits(b)
    else:
        txt = zh_int(int(s))
    return ("负" if neg else "") + txt


def _zh_hour(h: int) -> str:
    """Clock-hour reading: 2:00 is 两点, not 二点."""
    return "两" if h == 2 else zh_int(h)


# ---------------------------------------------------------------------------
# English number reading
# ---------------------------------------------------------------------------

EN_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
           "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
           "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
EN_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
           "eighty", "ninety"]
EN_SCALE = [(10 ** 9, "billion"), (10 ** 6, "million"), (1000, "thousand"),
            (100, "hundred")]


def en_int(n: int) -> str:
    if n < 0:
        return "minus " + en_int(-n)
    if n < 20:
        return EN_ONES[n]
    if n < 100:
        t, r = divmod(n, 10)
        return EN_TENS[t] + ("" if r == 0 else " " + EN_ONES[r])
    for scale, name in EN_SCALE:
        if n >= scale:
            head, rest = divmod(n, scale)
            out = en_int(head) + " " + name
            if rest:
                out += " " + en_int(rest)
            return out
    return EN_ONES[0]


def en_digits(s: str) -> str:
    return " ".join(EN_ONES[int(c)] if c.isdigit() else c for c in s)


def en_number(s: str) -> str:
    neg = s.startswith("-")
    if neg:
        s = s[1:]
    if "." in s:
        a, b = s.split(".", 1)
        txt = (en_int(int(a)) if a else "zero") + " point " + en_digits(b)
    else:
        txt = en_int(int(s))
    return ("minus " if neg else "") + txt


def en_year(n: int) -> str:
    """2002 → 'twenty oh two', 1999 → 'nineteen ninety nine'."""
    if 1000 <= n <= 9999:
        hi, lo = divmod(n, 100)
        if lo == 0:
            return en_int(hi) + " hundred"
        if lo < 10:
            return en_int(hi) + " oh " + en_int(lo)
        return en_int(hi) + " " + en_int(lo)
    return en_int(n)


_EN_ORD_IRREG = {1: "first", 2: "second", 3: "third", 5: "fifth", 8: "eighth",
                 9: "ninth", 12: "twelfth"}


def en_ordinal(n: int) -> str:
    """1 → 'first', 21 → 'twenty first', 30 → 'thirtieth'."""
    if n in _EN_ORD_IRREG:
        return _EN_ORD_IRREG[n]
    if n < 20:
        return EN_ONES[n] + "th"
    if n < 100:
        t, r = divmod(n, 10)
        if r == 0:
            return EN_TENS[t][:-1] + "ieth"
        return EN_TENS[t] + " " + en_ordinal(r)
    words = en_int(n).split()
    head, last = words[:-1], int(n % 100)
    if last and last < 100:
        base = en_int(n - last)
        return base + " " + en_ordinal(last)
    return " ".join(words) + "th"  # hundredth/thousandth/...


# ---------------------------------------------------------------------------
# Rule pipelines
# ---------------------------------------------------------------------------

_NUM = r"\d+(?:\.\d+)?"


# erhua whitelist: 儿 after these characters is rhotacisation, not the noun
# 儿 "child" (subset of WeTextProcessing's erhua list — the common cases).
_ERHUA_PRE = "玩花活事哪这那味头园盘片歌词曲画座们脸鸟劲门亮点面一会半伙孩娃"
_INTERJECTIONS = "嗯呃啊唉哎哦噢喔呀嘛吧呗啦咯哟"

# unicode roman numerals Ⅰ..Ⅻ / ⅰ..ⅻ (U+2160-216B, U+2170-217B)
_ROMAN_UC = "ⅠⅡⅢⅣⅤⅥⅦⅧⅨⅩⅪⅫ"
_ROMAN_LC = "ⅰⅱⅲⅳⅴⅵⅶⅷⅸⅹⅺⅻ"

# measure words after which a lone 2 is read 两 (WeTextProcessing's
# 二→两 idiom: 2个人 → 两个人, but 第2 → 第二 and 2月 → 二月)
_MEASURES = ("个只条张把件本辆位名台部架间家份杯瓶栋层块顶枚艘门颗粒棵株盏"
             "扇面批组届场趟回倍对双套段节首亩顿笔封包袋箱碗盘斤克吨"
             "米天周年岁点排列集页幅幕支盆朵卷枝")


class ZhNormalizer:
    """Chinese text normalizer: NSW → speakable Chinese.

    Rule depth targets the reference's executable spec
    (/root/reference/indextts/utils/front.py:437-483): dates (incl. y/m/d and
    y-m-d range forms), clock times, telephone numbers (1→幺), money (incl.
    symbol-before-magnitude: $3.5万), percents, fractions, score readings
    (比分3:2 → 三比二), ID/account digit-by-digit reading (工号1024 →
    幺零二四), ordinals, measure-word units, +-suffixed counts, number
    ranges, temperatures, signed bare numbers (负), and bare cardinals;
    optional 儿化 and interjection removal mirror WeTextProcessing's
    constructor flags. Golden corpus: tests/test_front.py (80 zh cases)."""

    def __init__(self, remove_erhua: bool = False,
                 remove_interjections: bool = False):
        self.remove_erhua = remove_erhua
        self.remove_interjections = remove_interjections
        n = _NUM

        def rng(m):  # N到M, both plain readings
            return zh_number(m.group(1)) + "到" + zh_number(m.group(2))

        def rng_y(m):  # currency range ¥3-5 → 三到五元
            return zh_number(m.group(1)) + "到" + zh_number(m.group(2)) + "元"

        def rng_d(m):  # $3-5 → 三到五美元
            return zh_number(m.group(1)) + "到" + zh_number(m.group(2)) + "美元"

        self.rules: List[Tuple[re.Pattern, Callable[[re.Match], str]]] = [
            # digit grouping: 1,000,000 → 1000000 (before everything)
            (re.compile(r"(?<!\d)(\d{1,3}(?:,\d{3})+)(?!\d)"),
             lambda m: m.group(1).replace(",", "")),
            # dates: 2030/1/2, 2023-04-05, 2025年01月11日
            (re.compile(r"(\d{4})\s*[/\-年]\s*(\d{1,2})\s*[/\-月]\s*(\d{1,2})\s*日?"),
             lambda m: f"{zh_digits(m.group(1))}年{zh_int(int(m.group(2)))}月"
                       f"{zh_int(int(m.group(3)))}日"),
            # date ranges: the dash between two date expressions reads 到
            # (1月-3月, 6月1日-6月3日) — endpoints converted by the date
            # rules around this one
            (re.compile(r"(?<=[月日号])\s*[~～\-—]\s*(?=\d{1,2}\s*[月日号]"
                        r"|\d{4}\s*年)"),
             lambda m: "到"),
            # time ranges 9:00-18:00 → 9:00到18:00 (times converted below)
            (re.compile(r"(\d{1,2}:\d{2}(?::\d{2})?)\s*[~～\-—]\s*"
                        r"(?=\d{1,2}:\d{2})"),
             lambda m: m.group(1) + "到"),
            # year ranges where only the right side carries 年:
            # 2023-2025年 → 二零二三到二零二五年
            (re.compile(r"(\d{4})\s*[~～\-—]\s*(?=\d{4}\s*年)"),
             lambda m: zh_digits(m.group(1)) + "到"),
            (re.compile(r"(\d{2,4})\s*年"),
             lambda m: zh_digits(m.group(1)) + "年"),
            (re.compile(r"(\d{1,2})\s*月(\d{1,2})\s*[日号]"),
             lambda m: f"{zh_int(int(m.group(1)))}月{zh_int(int(m.group(2)))}日"),
            # time HH:MM(:SS); 2点 is idiomatically 两点
            (re.compile(r"(\d{1,2}):(\d{2}):(\d{2})"),
             lambda m: f"{_zh_hour(int(m.group(1)))}点"
                       f"{zh_int(int(m.group(2)))}分"
                       f"{zh_int(int(m.group(3)))}秒"),
            (re.compile(r"(\d{1,2}):(\d{2})(?!\d)"),
             lambda m: f"{_zh_hour(int(m.group(1)))}点"
             + ("" if int(m.group(2)) == 0 else
                ("零" + zh_int(int(m.group(2))) if int(m.group(2)) < 10
                 else zh_int(int(m.group(2)))) + "分")),
            # score reading: colon pairs the time rules did NOT consume
            # (single-digit right side, or 3-digit sides) are X比Y —
            # 比分3:2 → 比分三比二, 大比分4:0 → 大比分四比零
            (re.compile(r"(\d{1,3}):(\d{1,3})"),
             lambda m: zh_int(int(m.group(1))) + "比"
             + zh_int(int(m.group(2)))),
            # hyphen/tilde ranges directly before a unit suffix run before the
            # phone rule (3-5元 is a range, not a number group): the right
            # endpoint is left for the unit rules below. -3~2℃ reads 零下;
            # the left endpoint may carry its own 万/亿 magnitude (3万-5万元).
            (re.compile(rf"(-?{n})\s*(万亿|亿|万)?\s*[~～\-—]\s*"
                        rf"(?={n}\s*(?:万亿|亿|万)?\s*(?:[元块%‰]|°C|℃|℉"
                        r"|万|亿|千米|千克|公斤|公里|厘米|毫米|毫升|米|岁|度|倍|人|次|天|年|个))"),
             lambda m: ("零下" + zh_number(m.group(1)[1:])
                        if m.group(1).startswith("-")
                        else zh_number(m.group(1)))
             + (m.group(2) or "") + "到"),
            # percent/permille and temperature ranges: the dash after the
            # unit reads 到 (50%-80% → 百分之五十到百分之八十; without this
            # the percent rule would read the dash as a 负 sign)
            (re.compile(r"(?<=[%‰])\s*[~～\-—]\s*(?=\d)"), lambda m: "到"),
            (re.compile(r"(?:(?<=℃)|(?<=℉)|(?<=°C)|(?<=°F))"
                        r"\s*[~～\-—]\s*(?=\d)"),
             lambda m: "到"),
            # currency ranges before the phone rule (¥100-200 is not a phone)
            (re.compile(rf"[¥￥]\s*({n})\s*[~～\-—]\s*[¥￥]?\s*({n})"), rng_y),
            (re.compile(rf"\$\s*({n})\s*[~～\-—]\s*\$?\s*({n})"), rng_d),
            # ID/account numbers after an explicit number-word read
            # digit-by-digit (1 → 幺, the phone convention): 工号1024 →
            # 工号幺零二四; runs before the phone/cardinal rules
            (re.compile(r"((?:号码|编号|账号|卡号|工号|学号|订单号|房间号|房号"
                        r"|身份证号?|验证码|邮编|车牌号|QQ号?)(?:[是为:：]|是)?"
                        r"\s*)(\d{3,})"),
             lambda m: m.group(1) + zh_digits_phone(m.group(2))),
            # telephone: separator-joined or bare 11-digit mobile / 3-4+7-8
            (re.compile(r"(?<![¥￥$\d.])\d{3,}(?:[-\s]\d{3,})+"),
             lambda m: zh_digits_phone(re.sub(r"[-\s]", "", m.group(0)))),
            (re.compile(r"(?<!\d)1[3-9]\d{9}(?!\d)"),
             lambda m: zh_digits_phone(m.group(0))),
            # money with a magnitude suffix: the symbol reads AFTER the
            # magnitude ($3.5万 → 三点五万美元, ¥2亿 → 两...二亿元)
            (re.compile(rf"[¥￥]\s*({n})\s*(万亿|亿|万)"),
             lambda m: zh_number(m.group(1)) + m.group(2) + "元"),
            (re.compile(rf"\$\s*({n})\s*(万亿|亿|万)"),
             lambda m: zh_number(m.group(1)) + m.group(2) + "美元"),
            # money
            (re.compile(rf"€\s*({n})\s*(万亿|亿|万)?"),
             lambda m: zh_number(m.group(1)) + (m.group(2) or "") + "欧元"),
            (re.compile(rf"£\s*({n})\s*(万亿|亿|万)?"),
             lambda m: zh_number(m.group(1)) + (m.group(2) or "") + "英镑"),
            (re.compile(rf"[¥￥]\s*({n})"), lambda m: zh_number(m.group(1)) + "元"),
            (re.compile(rf"\$\s*({n})"), lambda m: zh_number(m.group(1)) + "美元"),
            (re.compile(rf"({n})\s*[元块]"),
             lambda m: zh_number(m.group(1)) + m.group(0)[-1]),
            # percent / permille (signed: -0.5% → 负百分之零点五)
            (re.compile(rf"(-?)({n})\s*%"),
             lambda m: ("负" if m.group(1) else "")
             + "百分之" + zh_number(m.group(2))),
            (re.compile(rf"(-?)({n})\s*‰"),
             lambda m: ("负" if m.group(1) else "")
             + "千分之" + zh_number(m.group(2))),
            # temperature: negative reads 零下 (WeTextProcessing convention)
            (re.compile(rf"(-?)({n})\s*(?:°C|℃)"),
             lambda m: ("零下" if m.group(1) else "")
             + zh_number(m.group(2)) + "摄氏度"),
            (re.compile(rf"(-?)({n})\s*℉"),
             lambda m: ("零下" if m.group(1) else "")
             + zh_number(m.group(2)) + "华氏度"),
            # units (longest suffix first)
            (re.compile(rf"({n})\s*km/h"), lambda m: zh_number(m.group(1)) + "千米每小时"),
            (re.compile(rf"({n})\s*m/s"), lambda m: zh_number(m.group(1)) + "米每秒"),
            (re.compile(rf"({n})\s*(?:km²|km2)"), lambda m: zh_number(m.group(1)) + "平方千米"),
            (re.compile(rf"({n})\s*(?:m²|m2|㎡)(?![a-z])"), lambda m: zh_number(m.group(1)) + "平方米"),
            (re.compile(rf"({n})\s*kg"), lambda m: zh_number(m.group(1)) + "千克"),
            (re.compile(rf"({n})\s*km"), lambda m: zh_number(m.group(1)) + "千米"),
            (re.compile(rf"({n})\s*cm"), lambda m: zh_number(m.group(1)) + "厘米"),
            (re.compile(rf"({n})\s*mm"), lambda m: zh_number(m.group(1)) + "毫米"),
            (re.compile(rf"({n})\s*ml"), lambda m: zh_number(m.group(1)) + "毫升"),
            # score 比分 (X比Y) only between whitespace-free CJK context is
            # ambiguous with time; times were consumed above.
            # fraction a/b → b分之a (after dates & unit slashes)
            (re.compile(r"(?<![\d/.])(\d+)/(\d+)(?![\d/.])"),
             lambda m: zh_int(int(m.group(2))) + "分之" + zh_int(int(m.group(1)))),
            # ranges 3~5 / 3-5 (phones already consumed)
            (re.compile(rf"({n})\s*[~～\-—]\s*({n})"), rng),
            # "3000+" → 三千多, incl. magnitude suffixes (10万+ → 十万多);
            # a digit after the + is arithmetic (1+1), not a count suffix
            (re.compile(rf"({n})\s*(万亿|亿|万)?\s*\+(?!\s*\d)"),
             lambda m: zh_number(m.group(1)) + (m.group(2) or "") + "多"),
            # measure-word idiom: a lone 2 before a measure word reads 两
            # (2个人 → 两个人; 第2/12个/2.5 are excluded by the guards)
            (re.compile(rf"(?<![\d.第])2(?![\d.])\s*(?=[{_MEASURES}])"),
             lambda m: "两"),
            # unicode roman numerals (Ⅰ..Ⅻ) read as cardinals
            (re.compile(f"[{_ROMAN_UC}{_ROMAN_LC}]"),
             lambda m: zh_int((_ROMAN_UC + _ROMAN_LC).index(m.group(0)) % 12
                              + 1)),
            # signed bare numbers: a leading minus not part of a range /
            # date / phone (all consumed above) and not glued to letters
            # (product codes like A-1) reads 负 — 气温-5度 → 气温负五度
            (re.compile(rf"(?<![\dA-Za-z~～—\-])-({n})"),
             lambda m: "负" + zh_number(m.group(1))),
            # ordinals ride the bare-number rule (第3 → 第三)
            (re.compile(n), lambda m: zh_number(m.group(0))),
        ]

    def normalize(self, text: str) -> str:
        for pat, fn in self.rules:
            text = pat.sub(fn, text)
        if self.remove_interjections:
            text = re.sub(f"[{_INTERJECTIONS}]", "", text)
        if self.remove_erhua:
            text = re.sub(f"(?<=[{_ERHUA_PRE}])儿", "", text)
        return text


_EN_DECADE = {"10": "tens", "20": "twenties", "30": "thirties",
              "40": "forties", "50": "fifties", "60": "sixties",
              "70": "seventies", "80": "eighties", "90": "nineties"}

_FRACTION_DENOM = {2: ("half", "halves"), 3: ("third", "thirds"),
                   4: ("quarter", "quarters")}


def en_fraction(a: int, b: int) -> str:
    if b in _FRACTION_DENOM:
        one, many = _FRACTION_DENOM[b]
    else:
        one = en_ordinal(b)
        many = one + "s"
    return en_int(a) + " " + (one if a == 1 else many)


class EnNormalizer:
    """English text normalizer: NSW → speakable English.

    Covers the reference corpus' English cases
    (/root/reference/indextts/utils/front.py:437-483): clock times, money,
    percents, years, ordinals (1st/2nd/...), fractions, phone-style digit
    runs, and bare cardinals. Spelled-out numbers are space-padded when glued
    to letters ('beta2' → 'beta two')."""

    def __init__(self):
        n = _NUM

        def pad(m, txt):
            """Insert spaces when the match butts against letters."""
            s, e = m.start(), m.end()
            text = m.string
            lo = " " if s > 0 and text[s - 1].isalpha() else ""
            hi = " " if e < len(text) and text[e].isalpha() else ""
            return lo + txt + hi

        self.rules: List[Tuple[re.Pattern, Callable[[re.Match], str]]] = [
            # digit grouping in unit contexts ($1,234 / 1,234%) only strips
            # the commas — the money/percent rules read the result
            (re.compile(r"(?:(?<=[$€£])|(?=\d[\d,]*%))(\d{1,3}(?:,\d{3})+)"),
             lambda m: m.group(1).replace(",", "")),
            # elsewhere digit grouping reads as a CARDINAL directly (1,234
            # is a count, never a year — '1,234 left' must not ride the
            # year rule)
            (re.compile(r"(?<![\d$€£])(\d{1,3}(?:,\d{3})+)(?![\d%])"),
             lambda m: pad(m, en_number(m.group(1).replace(",", "")))),
            # time; the am/pm suffix keeps its \s* INSIDE the optional group
            # (a bare \s* before an unmatched suffix eats the space and
            # glues the next word: '10:30 a.m.' -> 'ten thirtya.m.'), takes
            # dotted forms, and refuses to eat word prefixes ('10:30 among')
            # dotted forms need BOTH dots (a.m.), bare forms take none (pm) —
            # 'pm.' must leave the sentence dot for the splitter
            (re.compile(
                r"(\d{1,2}):00(?:\s*([AaPp]\.[Mm]\.|[AaPp][Mm])(?![a-zA-Z]))?"),
             lambda m: en_int(int(m.group(1))) + " o'clock"
             + (f" {' '.join(m.group(2).replace('.', '').upper())}"
                if m.group(2) else "")),
            (re.compile(
                r"(\d{1,2}):(\d{2})"
                r"(?:\s*([AaPp]\.[Mm]\.|[AaPp][Mm])(?![a-zA-Z]))?"),
             lambda m: en_int(int(m.group(1))) + " "
             + (("oh " if int(m.group(2)) < 10 else "")
                + en_int(int(m.group(2))))
             + (f" {' '.join(m.group(3).replace('.', '').upper())}"
                if m.group(3) else "")),
            # emergency/short service numbers after call/dial read
            # digit-by-digit: Call 911 → Call nine one one
            (re.compile(r"\b(call|dial)\s+(\d{3})(?![\d\-])",
                        re.IGNORECASE),
             lambda m: m.group(1) + " " + en_digits(m.group(2))),
            # year ranges BEFORE the phone rule: 1990-1995 → year to year
            (re.compile(r"\b(1[0-9]{3}|20[0-9]{2})\s*[-~～—]\s*"
                        r"(1[0-9]{3}|20[0-9]{2})\b"),
             lambda m: en_year(int(m.group(1))) + " to "
             + en_year(int(m.group(2)))),
            # phone-style digit runs
            (re.compile(r"\d{3,}(?:-\d{3,})+"),
             lambda m: en_digits(re.sub(r"-", "", m.group(0)))),
            # currency ranges: $3-5 → three to five dollars
            (re.compile(rf"\$\s*({n})\s*[-~～—]\s*\$?\s*({n})"),
             lambda m: en_number(m.group(1)) + " to "
             + en_number(m.group(2)) + " dollars"),
            # money
            (re.compile(rf"\$\s*({n})"),
             lambda m: en_number(m.group(1)) + " dollars"
             if m.group(1) not in ("1", "1.0") else "one dollar"),
            (re.compile(rf"€\s*({n})"),
             lambda m: en_number(m.group(1)) + " euros"
             if m.group(1) not in ("1", "1.0") else "one euro"),
            (re.compile(rf"£\s*({n})"),
             lambda m: en_number(m.group(1)) + " pounds"
             if m.group(1) not in ("1", "1.0") else "one pound"),
            # percent ranges: the dash after % reads "to"
            (re.compile(r"(?<=%)\s*[-~～—]\s*(?=\d)"), lambda m: " to "),
            (re.compile(rf"(-?)({n})\s*%"),
             lambda m: ("minus " if m.group(1) else "")
             + en_number(m.group(2)) + " percent"),
            # temperature: -5°C → minus five degrees Celsius
            (re.compile(rf"(-?)({n})\s*(?:°C|℃)"),
             lambda m: ("minus " if m.group(1) else "")
             + en_number(m.group(2)) + " degrees Celsius"),
            (re.compile(rf"(-?)({n})\s*(?:°F|℉)"),
             lambda m: ("minus " if m.group(1) else "")
             + en_number(m.group(2)) + " degrees Fahrenheit"),
            # ordinals
            (re.compile(r"\b(\d+)\s*(st|nd|rd|th)\b", re.IGNORECASE),
             lambda m: en_ordinal(int(m.group(1)))),
            # "+"-suffixed counts: 50+ cars → fifty plus cars
            (re.compile(rf"({n})\s*\+"),
             lambda m: en_number(m.group(1)) + " plus"),
            # the idiom 24/7 is not a fraction
            (re.compile(r"\b24/7\b"), lambda m: "twenty four seven"),
            # fractions (not dates/units)
            (re.compile(r"(?<![\d/.])(\d+)/(\d+)(?![\d/.])"),
             lambda m: en_fraction(int(m.group(1)), int(m.group(2)))),
            # decades: 1980s → nineteen eighties, 1900s → nineteen
            # hundreds, 2000s → two thousands, 2010s → twenty tens
            (re.compile(r"\b(1[0-9]|20)([0-9]0|00)s\b"),
             lambda m: ("two thousands" if m.group(0) == "2000s" else
                        en_int(int(m.group(1))) + " " +
                        ("hundreds" if m.group(2) == "00" else
                         _EN_DECADE[m.group(2)]))),
            # years
            (re.compile(r"\b(1[0-9]{3}|20[0-9]{2})\b"),
             lambda m: en_year(int(m.group(0)))),
            # small-number ranges: pages 10-20 → ten to twenty (AFTER years/
            # phones/ordinals; hyphenated words like 5.5-inch keep the dash
            # because the right side is not a bare integer)
            (re.compile(r"\b(\d{1,3})\s*[-~～—]\s*(\d{1,3})\b(?![\d.\-])"),
             lambda m: en_int(int(m.group(1))) + " to "
             + en_int(int(m.group(2)))),
            # signed bare numbers (ranges/phones/dates consumed above;
            # hyphenated words like all-4 keep the dash via the letter guard)
            (re.compile(rf"(?<![\dA-Za-z~～—\-])-({n})"),
             lambda m: pad(m, "minus " + en_number(m.group(1)))),
            # bare numbers (space-padded against letters: beta2 → beta two)
            (re.compile(n), lambda m: pad(m, en_number(m.group(0)))),
        ]

    def normalize(self, text: str) -> str:
        for pat, fn in self.rules:
            text = pat.sub(fn, text)
        return text
