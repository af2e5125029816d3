from .olm import CARD_TABLE, card_type_valid, luhn_checksum  # noqa: F401
