"""Text frontend: normalizer + tokenizer + sentence splitting.

Behavioural spec: utils/front.py of the reference (TextNormalizer:11-229,
TextTokenizer:232-429) — pinyin-tone placeholder save/restore, CJK-name
protection, English contraction expansion, full/half-width char mapping,
jqx pinyin correction, CJK char pre-tokenization, sentencepiece BPE, and
punctuation-aware sentence splitting with re-split + greedy re-merge.

The heavy normalization engine is utils/tn.py (self-contained); if the
optional WeTextProcessing package exists it is used instead, matching the
reference's dependency ladder.
"""
from __future__ import annotations

import re
import warnings
from typing import List, Optional, Sequence, Union

from index_tts_dubbing_tpu_torch.utils import tn
from index_tts_dubbing_tpu_torch.utils.sp_model import SentencePieceBPE

# CJK codepoint ranges (same set as NLTK's tokenize util; matches the
# behaviour of the reference utils/common.py:46-51)
CJK_RANGE_PATTERN = (
    "([\u1100-\u11ff\u2e80-\ua4cf\ua840-\uD7AF\uF900-\uFAFF"
    "\uFE30-\uFE4F\uFF65-\uFFDC\U00020000-\U0002FFFF])"
)


def tokenize_by_cjk_char(line: str, do_upper_case: bool = True) -> str:
    """'你好是 hello' → '你 好 是 HELLO' (utils/common.py:29-51)."""
    chars = re.split(CJK_RANGE_PATTERN, line.strip())
    return " ".join(w.strip().upper() if do_upper_case else w.strip()
                    for w in chars if w.strip())


def de_tokenize_by_cjk_char(line: str, do_lower_case: bool = False) -> str:
    """Inverse of tokenize_by_cjk_char (utils/common.py:54-81)."""
    english_word_pattern = re.compile(r"([A-Z]+(?:[\s-][A-Z-]+)*)", re.IGNORECASE)
    english_sents = english_word_pattern.findall(line)
    for i, sent in enumerate(english_sents):
        line = line.replace(sent, f"<sent_{i}>")
    words = line.split()
    placeholder = re.compile(r"^.*?(<sent_(\d+)>)")
    for i, w in enumerate(words):
        m = placeholder.match(w)
        if m:
            restored = english_sents[int(m.group(2))]
            if do_lower_case:
                restored = restored.lower()
            words[i] = w.replace(m.group(1), restored)
    return "".join(words)


class TextNormalizer:
    """zh/en text normalization with pinyin/name placeholder protection."""

    PINYIN_TONE_PATTERN = (
        r"(?<![a-z])((?:[bpmfdtnlgkhjqxzcsryw]|[zcs]h)?"
        r"(?:[aeiouüv]|[ae]i|u[aio]|ao|ou|i[aue]|[uüv]e|[uvü]ang?|uai|"
        r"[aeiuv]n|[aeio]ng|ia[no]|i[ao]ng)|ng|er)([1-5])"
    )
    NAME_PATTERN = "[\u4e00-\u9fff]+(?:[-\u00b7\u2014][\u4e00-\u9fff]+){1,2}"
    ENGLISH_CONTRACTION_PATTERN = (
        r"(what|where|who|which|how|t?here|it|s?he|that|this)'s"
    )

    def __init__(self):
        self.zh_normalizer = None
        self.en_normalizer = None
        self.char_rep_map = {
            "：": ",", "；": ",", ";": ",", "，": ",", "。": ".", "！": "!",
            "？": "?", "\n": " ", "·": "-", "、": ",", "...": "…", ",,,": "…",
            "，，，": "…", "……": "…", "“": "'", "”": "'", '"': "'", "‘": "'",
            "’": "'", "（": "'", "）": "'", "(": "'", ")": "'", "《": "'",
            "》": "'", "【": "'", "】": "'", "[": "'", "]": "'", "—": "-",
            "～": "-", "~": "-", "「": "'", "」": "'", ":": ",",
        }
        self.zh_char_rep_map = {"$": ".", **self.char_rep_map}

    def load(self):
        if self.zh_normalizer is not None and self.en_normalizer is not None:
            return
        try:  # optional: prefer WeTextProcessing when available
            from tn.chinese.normalizer import Normalizer as NormalizerZh
            from tn.english.normalizer import Normalizer as NormalizerEn
            self.zh_normalizer = NormalizerZh(remove_interjections=False,
                                              remove_erhua=False,
                                              overwrite_cache=False)
            self.en_normalizer = NormalizerEn(overwrite_cache=False)
        except Exception:
            self.zh_normalizer = tn.ZhNormalizer()
            self.en_normalizer = tn.EnNormalizer()

    def match_email(self, email: str) -> bool:
        return re.match(r"^[a-zA-Z0-9]+@[a-zA-Z0-9]+\.[a-zA-Z]+$", email) is not None

    def use_chinese(self, s: str) -> bool:
        has_chinese = bool(re.search("[\u4e00-\u9fff]", s))
        has_alpha = bool(re.search(r"[a-zA-Z]", s))
        if has_chinese or not has_alpha or self.match_email(s):
            return True
        return bool(re.search(self.PINYIN_TONE_PATTERN, s, re.IGNORECASE))

    def correct_pinyin(self, pinyin: str) -> str:
        """jqx + u/ü → v (front.py:145-156)."""
        if pinyin[0] not in "jqxJQX":
            return pinyin
        pinyin = re.sub(r"([jqx])[uü](n|e|an)*(\d)", r"\g<1>v\g<2>\g<3>",
                        pinyin, flags=re.IGNORECASE)
        return pinyin.upper()

    def _save_by_pattern(self, text: str, pattern: str, tag: str):
        found = re.findall(pattern, text, re.IGNORECASE)
        if not found:
            return text, None
        items = list(dict.fromkeys("".join(f) for f in found))
        for i, item in enumerate(items):
            text = text.replace(item, f"<{tag}_{chr(ord('a') + i)}>")
        return text, items

    def _restore_by_tag(self, text: str, items, tag: str, fix=None):
        if not items:
            return text
        for i, item in enumerate(items):
            if fix:
                item = fix(item)
            text = text.replace(f"<{tag}_{chr(ord('a') + i)}>", item)
        return text

    def normalize(self, text: str) -> str:
        text = text.replace("嗯", "恩").replace("呣", "母")
        if not self.zh_normalizer or not self.en_normalizer:
            self.load()
        if self.use_chinese(text):
            text = re.sub(self.ENGLISH_CONTRACTION_PATTERN, r"\1 is", text,
                          flags=re.IGNORECASE)
            text, pinyins = self._save_by_pattern(
                text.rstrip(), self.PINYIN_TONE_PATTERN, "pinyin")
            text, names = self._save_by_pattern(text, self.NAME_PATTERN, "n")
            try:
                result = self.zh_normalizer.normalize(text)
            except Exception:
                result = text
            result = self._restore_by_tag(result, names, "n")
            result = self._restore_by_tag(result, pinyins, "pinyin",
                                          fix=self.correct_pinyin)
            rep = self.zh_char_rep_map
        else:
            text = re.sub(self.ENGLISH_CONTRACTION_PATTERN, r"\1 is", text,
                          flags=re.IGNORECASE)
            try:
                result = self.en_normalizer.normalize(text)
            except Exception:
                result = text
            rep = self.char_rep_map
        pattern = re.compile("|".join(re.escape(p) for p in rep))
        return pattern.sub(lambda x: rep[x.group()], result)


class TextTokenizer:
    """sentencepiece-BPE tokenizer with CJK pre-tokenization and sentence
    splitting (front.py:232-429)."""

    punctuation_marks_tokens = [".", "!", "?", "▁.", "▁?", "▁..."]

    def __init__(self, vocab_file: str, normalizer: Optional[TextNormalizer] = None):
        if vocab_file is None:
            raise ValueError("vocab_file is None")
        self.normalizer = normalizer
        if self.normalizer:
            self.normalizer.load()
        self.sp_model = SentencePieceBPE.from_file(vocab_file)
        self.pre_tokenizers = [tokenize_by_cjk_char]

    @property
    def vocab_size(self) -> int:
        return self.sp_model.get_piece_size()

    unk_token = "<unk>"
    bos_token = "<s>"
    eos_token = "</s>"
    pad_token = None
    pad_token_id = -1
    bos_token_id = 0
    eos_token_id = 1

    @property
    def unk_token_id(self):
        return self.sp_model.unk_id()

    def convert_ids_to_tokens(self, ids):
        return self.sp_model.id_to_piece(ids)

    def convert_tokens_to_ids(self, tokens) -> List[int]:
        if isinstance(tokens, str):
            tokens = [tokens]
        return [self.sp_model.piece_to_id(t) for t in tokens]

    def tokenize(self, text: str) -> List[str]:
        return self.encode(text, out_type=str)

    def encode(self, text: str, out_type=int):
        if len(text) == 0:
            return []
        if len(text.strip()) == 1:
            return self.sp_model.encode(text, out_type=out_type)
        if self.normalizer:
            text = self.normalizer.normalize(text)
        for pre in self.pre_tokenizers:
            text = pre(text)
        return self.sp_model.encode(text, out_type=out_type)

    def batch_encode(self, texts: Sequence[str], **kw):
        return [self.encode(t, **kw) for t in texts]

    def decode(self, ids, do_lower_case: bool = False) -> str:
        if isinstance(ids, int):
            ids = [ids]
        return de_tokenize_by_cjk_char(self.sp_model.decode(ids),
                                       do_lower_case=do_lower_case)

    @staticmethod
    def split_sentences_by_token(tokenized: List[str], split_tokens: List[str],
                                 max_tokens_per_sentence: int) -> List[List[str]]:
        """Punctuation split with ≤max re-split (by , then - then hard cut)
        and greedy merge of short neighbours (front.py:345-415)."""
        if len(tokenized) == 0:
            return []
        sentences: List[List[str]] = []
        current: List[str] = []
        i = 0
        while i < len(tokenized):
            token = tokenized[i]
            current.append(token)
            if len(current) <= max_tokens_per_sentence:
                if token in split_tokens and len(current) > 2:
                    if i < len(tokenized) - 1 and tokenized[i + 1] in ("'", "▁'"):
                        current.append(tokenized[i + 1])
                        i += 1
                    sentences.append(current)
                    current = []
                i += 1
                continue
            # over limit: re-split the accumulated chunk
            if not set(split_tokens) & {",", "▁,"} and \
                    ({",", "▁,"} & set(current)):
                subs = TextTokenizer.split_sentences_by_token(
                    current, [",", "▁,"], max_tokens_per_sentence)
            elif "-" not in split_tokens and "-" in current:
                subs = TextTokenizer.split_sentences_by_token(
                    current, ["-"], max_tokens_per_sentence)
            else:
                subs = [current[j:j + max_tokens_per_sentence]
                        for j in range(0, len(current), max_tokens_per_sentence)]
                warnings.warn(
                    f"The tokens length of sentence exceeds limit: "
                    f"{max_tokens_per_sentence}, Tokens in sentence: {current}. "
                    "Maybe unexpected behavior", RuntimeWarning)
            sentences.extend(subs)
            current = []
            i += 1
        if current:
            sentences.append(current)
        merged: List[List[str]] = []
        for s in sentences:
            if not s:
                continue
            if merged and len(merged[-1]) + len(s) <= max_tokens_per_sentence:
                merged[-1] = merged[-1] + s
            else:
                merged.append(s)
        return merged

    def split_sentences(self, tokenized: List[str],
                        max_tokens_per_sentence: int = 120) -> List[List[str]]:
        return self.split_sentences_by_token(
            tokenized, self.punctuation_marks_tokens,
            max_tokens_per_sentence=max_tokens_per_sentence)
