from .fields import (
    tokenize,
    FieldTokenizer,
    DefaultTokenizer,
    StemmedTokenizer,
    IdentityTokenizer,
    BigramTokenizer,
    TrigramTokenizer,
    UrlTokenizer,
    NewlineTokenizer,
    JsonFieldTokenizer,
    get_tokenizer,
)
