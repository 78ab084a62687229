from .text_field import TextField, TEXT_FIELDS, text_field, NUM_TEXT_FIELDS
from .numerical_field import (
    NumericalField,
    NUMERICAL_FIELDS,
    numerical_field,
    NUM_NUMERICAL_FIELDS,
)
